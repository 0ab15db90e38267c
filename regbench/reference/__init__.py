"""The plain references of the benchmark: plain PyTorch, nothing of the
program, JAX or the JAX package.

Each configuration names its reference by the key ``"reference"``, the
module ``reference/<name>.py``, which the harness loads by its file as it
loads a generator. A reference module has::

    solve(src, dst, solver, dtype=..., graph_dtype=...) -> Reference

on ``(P, 3, n)`` tensors on their device, with ``solver`` the
configuration's ``"solver"`` object: it works out from the inputs alone, in
``dtype`` after the graph and ``graph_dtype`` for it (the control passes a
type below the configuration's), a ``Reference`` of

* ``rotation`` ``(P, 3, 3)`` and ``translation`` ``(P, 3)``, float64;
* ``scale`` ``(P,)`` float64, ones where the configuration fixes s = 1;
* ``inliers`` ``(P, n)`` bool, the selected inlier set;
* ``decided`` ``(P,)`` bool, whether the reference could certify it.

A reference of a configuration that certifies its answers gives a result
that also has ``optimal`` ``(P,)`` bool and ``suboptimality`` ``(P,)``
float64, its certifier's verdict and best gap; the harness reads them by
name, and only in a cell whose limits name ``cert_flips`` and
``subopt_diff`` (``checks.py``).

A reference imports nothing of the program and takes nothing the program
made: it reads the generator's inputs and the configuration.
"""
