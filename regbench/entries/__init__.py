"""Adapters from the benchmark's requests to the program's entry points.

Each module ``entries/<entry>.py`` has ``open(solver, args, device)``,
returning an object whose ``solve(src, dst, stage_ms)`` runs one request of
host arrays ``(k, 3, n)`` through the entry and returns the answers on the
host: rotations ``(k, 3, 3)``, translations ``(k, 3)`` and selected inlier
masks ``(k, n)``. With a dict as ``stage_ms`` it adds the program's own
stage times, in ms, where the entry reports them. ``stage_timing`` says
whether stage times cost the entry syncs it does not make otherwise.
"""
