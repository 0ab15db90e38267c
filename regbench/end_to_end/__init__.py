"""End-to-end metrics: ``end_to_end/<name>.py`` (or the file of the part
of the name before its first dot) has ``read(record)``, where ``record``
holds ``setup_s``, ``failed`` (the registrations that failed the
comparison) and what the traffic's driver measured: for a closed loop
``window_s``, ``latencies_s`` (one a request) and ``attempted``."""
