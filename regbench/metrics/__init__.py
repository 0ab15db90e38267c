"""Per-layer metrics: ``metrics/<name>.py``, or else the file of the part
of the name before its first dot (``idle_pct.py`` reads ``idle_pct.batch``
and ``idle_pct.facade``), has ``read(layers)``, where ``layers`` is
``run.Layers`` (the reduced trace of the profiled requests, the program's
stage times of the rest of the window, the card's name, the shapes and
what else the traffic's driver measured). A reader that finds nothing
returns None and the metric is left out of the line."""
