"""Plain reference of TEASER++'s registration from raw clouds, in PyTorch.

Upstream's ``examples/teaser_cpp_fpfh/teaser_cpp_fpfh.cc`` finds the
correspondences itself: FPFH descriptors of each cloud
(``teaser::FPFHEstimation``, which runs PCL's ``NormalEstimationOMP`` and
``FPFHEstimationOMP``), mutual nearest neighbours of the descriptors
(``teaser::Matcher`` with cross-check and no tuple test), then the robust
solve on the matched points. This module works each step out again from
the two clouds alone, written from PCL's and upstream's semantics:

* radius neighbours: every ordered pair ``(p, q)`` with ``|q - p|^2 <=
  r^2``, self included, by direct differences ``dx^2 + dy^2 + dz^2`` summed
  left to right, over blocks of query points against the whole cloud
  (PCL's kd-tree radius search; ``r^2`` taken in double and rounded once);
* normals (``NormalEstimation::computePointNormal``): the covariance of the
  neighbourhood about its centroid, ``E[d d^T] - E[d] E[d]^T`` over the
  offsets ``d = q - p``; the eigenvector of its least eigenvalue; turned to
  face the viewpoint, the origin (``flipNormalTowardsViewpoint``: negated
  where ``(v - p) . n < 0``). A neighbourhood of fewer than 3 points has no
  normal (PCL's ``computePointNormal`` makes it NaN);
* SPFH (``computePointSPFHSignature``, ``computePairFeatures``): for each
  neighbour ``q != p`` within the FPFH radius, ``d = q - p``, ``angle1 =
  n_p . d / |d|``, ``angle2 = n_q . d / |d|``; where ``acos|angle1| >
  acos|angle2|`` (``|angle1| < |angle2|``) source and target swap, ``d``
  is negated and ``f3 = -angle2``, else ``f3 = angle1``; with ``u`` the
  source's normal and ``n_t`` the target's, ``v = d x u / |d x u|``, ``w =
  u x v``, ``f2 = v . n_t``, ``f1 = atan2(w . n_t, u . n_t)``; bins
  ``floor(11 (f1 + pi) / (2 pi))``, ``floor(11 (f2 + 1) / 2)``,
  ``floor(11 (f3 + 1) / 2)`` clipped to [0, 10], each pair adding ``100 /
  (k - 1)`` for ``k`` neighbours, self included. A pair at distance 0 or
  with ``d x u = 0`` adds nothing (``computePairFeatures`` returns false),
  nor does a pair with an undefined normal at either end, which still counts
  in ``k``;
* FPFH (``weightPointSPFHSignature``): the neighbours' SPFHs within the
  FPFH radius, each weighted by ``1 / |q - p|^2`` (PCL's radius search
  gives squared distances; the point itself, at distance 0, is passed
  over), each 11-bin block scaled to sum to 100 where its sum is not 0;
* the matcher (``Matcher::calculateCorrespondences`` with cross-check):
  ``(i, j)`` when ``j`` is the nearest target descriptor of source ``i``
  and ``i`` the nearest source descriptor of ``j``, in squared Euclidean
  distance over the 33 bins, ties to the lowest index; sorted. The nearest
  neighbour is exact: a float64 Gram product screens the candidates within
  its rounding bound of the least, and the squared differences, in
  float64, decide among them;
* then the known-scale reference (``registration.py``), imported and not
  copied, on the matched points: the TRIM graph, its top k-core, GNC-TLS
  and the TLS translation. Source point ``i`` is selected when a
  correspondence ``(i, j)`` is in the clique;
* where the top core is no clique (a match a few millimetres off its true
  target agrees with most inliers, not all), a plain exact search finds the
  maximum clique (:func:`max_clique`): a clique peeled from the top core
  bounds it, and the vertices of the core of that bound, all of which but a
  few hundred miss no edge among them, hold every larger clique. A problem
  whose search passes its bound of nodes is undecided.

The front end runs in ``graph_dtype`` (the configuration's float32; the
control passes bfloat16), the eigenvectors in float32 at least (PyTorch has
no eigensolver below it); TF32 is turned off, so no float32 product runs in
a lower precision.

Departures from PCL and upstream:

* a pair with an undefined normal adds nothing, as in the program's
  ``FPFHEstimation``; in PCL its NaN features fall in bin 0 of each
  histogram that reads the NaN normal (all three where the query's normal
  is NaN, f1 and f2 where the neighbour's is), through the float-to-int
  conversion of x86;
* the nearest neighbours are exact, where upstream's FLANN kd-trees are
  approximate (128 checks);
* the neighbours are found by direct differences over the whole cloud,
  not by a kd-tree: the same pairs, bar pairs within an ulp of the radius.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# The harness loads a reference by its file, as a module of no package; name
# the package so that the known-scale reference is found beside this one.
if not __package__:
    __package__ = "regbench.reference"
from . import registration as known  # noqa: E402

Reference = known.Reference

NR_BINS = 11


def radius_table(pts: torch.Tensor, radius: float, pairs_per_block: int = 2 ** 28
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every point's neighbours within ``radius``, self included: ``(idx,
    d2)``, each ``(n, K)`` with ``K`` the largest neighbourhood, a row's
    neighbours in index order and padded with ``n`` (``d2`` 0 there).

    ``pts`` ``(n, 3)`` in the dtype of the arithmetic; query blocks of about
    ``pairs_per_block`` pairs against the whole cloud."""
    n = pts.shape[0]
    r2 = torch.tensor(radius * radius, dtype=pts.dtype, device=pts.device)
    rows = max(1, pairs_per_block // max(n, 1))
    q_all, c_all, d_all = [], [], []
    for q0 in range(0, n, rows):
        q = pts[q0:q0 + rows]
        dx = pts[None, :, 0] - q[:, 0, None]
        dy = pts[None, :, 1] - q[:, 1, None]
        dz = pts[None, :, 2] - q[:, 2, None]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        qi, ci = torch.nonzero(d2 <= r2, as_tuple=True)
        q_all.append(qi + q0)
        c_all.append(ci)
        d_all.append(d2[qi, ci])
        del d2
    qi, ci, d2 = torch.cat(q_all), torch.cat(c_all), torch.cat(d_all)
    # nonzero lists a block row by row, each row's columns in order
    count = torch.bincount(qi, minlength=n)
    k = int(count.max()) if n else 0
    start = torch.cumsum(count, 0) - count
    slot = torch.arange(len(qi), device=pts.device) - start[qi]
    idx = torch.full((n, k), n, dtype=torch.int64, device=pts.device)
    dd = torch.zeros((n, k), dtype=pts.dtype, device=pts.device)
    idx[qi, slot] = ci
    dd[qi, slot] = d2
    return idx, dd


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with the padding index ``n`` reading a zero row."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])[idx]


def normals(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(n, 3)`` unit normals from the neighbour table ``idx`` of
    :func:`radius_table`, turned to face the origin; a row of fewer than 3
    neighbours holds the eigensolver's vector, which :func:`spfh` passes
    over."""
    n = pts.shape[0]
    real = idx < n
    m = real.to(pts.dtype)
    d = (_gather(pts, idx) - pts[:, None, :]) * m[..., None]  # (n, K, 3) offsets
    k = m.sum(dim=1)
    mean = d.sum(dim=1) / k[:, None]
    cov = torch.einsum("nki,nkj->nij", d, d) / k[:, None, None] \
        - mean[:, :, None] * mean[:, None, :]
    cov = cov.to(torch.promote_types(cov.dtype, torch.float32))
    # eigenvalues ascend: the least one's vector; batches of 8,192 matrices,
    # as cuSOLVER's batched solver takes no batch of 100,000 3x3 matrices
    nrm = torch.cat([torch.linalg.eigh(c)[1][..., 0] for c in cov.split(8192)]).to(pts.dtype)
    flip = ((-pts) * nrm).sum(dim=-1) < 0
    return torch.where(flip[:, None], -nrm, nrm)


def _bin(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x), 0, NR_BINS - 1).to(torch.int64)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def spfh(pts: torch.Tensor, nrm: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
         defined: torch.Tensor) -> torch.Tensor:
    """``(n, 33)`` SPFH of every point from its neighbours ``idx`` within the
    FPFH radius (``d2`` their squared distances); ``defined`` ``(n,)`` bool
    marks the points that have a normal."""
    n = pts.shape[0]
    real = idx < n
    diff = _gather(pts, idx) - pts[:, None, :]
    dist = torch.sqrt(d2)
    pos = real & (d2 > 0) & defined[:, None] & _gather(defined, idx)
    safe = torch.where(pos, dist, torch.ones_like(dist))
    n_p = nrm[:, None, :].expand_as(diff)
    n_q = _gather(nrm, idx)
    angle1 = _dot(n_p, diff) / safe
    angle2 = _dot(n_q, diff) / safe
    swap = angle1.abs() < angle2.abs()
    u = torch.where(swap[..., None], n_q, n_p)
    nt = torch.where(swap[..., None], n_p, n_q)
    dvec = torch.where(swap[..., None], -diff, diff)
    f3 = torch.where(swap, -angle2, angle1)
    v = _cross(dvec, u)
    vn = torch.sqrt(_dot(v, v))
    ok = pos & (vn > 0)
    v = v / torch.where(vn > 0, vn, torch.ones_like(vn))[..., None]
    w = _cross(u, v)
    f2 = _dot(v, nt)
    f1 = torch.atan2(_dot(w, nt), _dot(u, nt))
    pi = math.pi
    bins = (_bin(NR_BINS * (f1 + pi) / (2 * pi)), _bin(NR_BINS * (f2 + 1.0) * 0.5),
            _bin(NR_BINS * (f3 + 1.0) * 0.5))
    hist = torch.zeros((n, 3 * NR_BINS), dtype=pts.dtype, device=pts.device)
    okf = ok.to(pts.dtype)
    for i, b in enumerate(bins):  # counts of whole pairs: exact in any order
        hist.scatter_add_(1, b + i * NR_BINS, okf)
    k = real.sum(dim=1).to(pts.dtype)
    return hist * (100.0 / torch.clamp(k - 1.0, min=1.0))[:, None]


def fpfh(spfh_: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """``(n, 33)`` FPFH: the neighbours' SPFHs weighted by ``1 / d2`` (the
    point itself and the padding passed over), each 11-bin block scaled to
    sum to 100 where its sum is not 0."""
    n = spfh_.shape[0]
    use = (idx < n) & (d2 > 0)
    wgt = torch.where(use, 1.0 / torch.where(use, d2, torch.ones_like(d2)),
                      torch.zeros_like(d2))
    raw = (wgt[..., None] * _gather(spfh_, idx)).sum(dim=1)
    out = []
    for b in range(3):
        seg = raw[:, b * NR_BINS:(b + 1) * NR_BINS]
        s = seg.sum(dim=-1, keepdim=True)
        out.append(torch.where(s != 0, seg * (100.0 / torch.where(s != 0, s, torch.ones_like(s))),
                               seg))
    return torch.cat(out, dim=-1)


def descriptors(cloud: torch.Tensor, radii, dtype: torch.dtype) -> torch.Tensor:
    """``(n, 33)`` FPFH of a ``(3, n)`` cloud at ``radii`` (normals, FPFH)."""
    pts = cloud.T.contiguous().to(dtype)
    idx_n, _ = radius_table(pts, radii[0])
    nrm = normals(pts, idx_n)
    defined = (idx_n < pts.shape[0]).sum(dim=1) >= 3
    del idx_n
    idx_f, d2_f = radius_table(pts, radii[1])
    return fpfh(spfh(pts, nrm, idx_f, d2_f, defined), idx_f, d2_f)


def nearest(queries: torch.Tensor, database: torch.Tensor, rows_per_block: int = 2048
            ) -> torch.Tensor:
    """Index of each query's nearest database row, ties to the lowest.

    A float64 Gram product ranks every pair; a pair within twice its
    rounding bound of the query's least is a candidate, and the squared
    differences summed in float64 decide among the candidates."""
    q64, db64 = queries.to(torch.float64), database.to(torch.float64)
    qn, dn = (q64 * q64).sum(dim=1), (db64 * db64).sum(dim=1)
    scale = 1e-12 * (qn + dn.max())
    out = []
    for r0 in range(0, len(q64), rows_per_block):
        q = q64[r0:r0 + rows_per_block]
        g = qn[r0:r0 + rows_per_block, None] + dn[None, :] - 2.0 * (q @ db64.T)
        thr = g.amin(dim=1) + 2.0 * scale[r0:r0 + rows_per_block]
        qi, ci = torch.nonzero(g <= thr[:, None], as_tuple=True)
        del g
        exact = ((q[qi] - db64[ci]) ** 2).sum(dim=1)
        best = torch.full((len(q),), float("inf"), dtype=torch.float64, device=q.device)
        best.scatter_reduce_(0, qi, exact, "amin")
        at_best = exact == best[qi]
        pick = torch.full((len(q),), len(db64), dtype=torch.int64, device=q.device)
        pick.scatter_reduce_(0, qi[at_best], ci[at_best], "amin")
        out.append(pick)
    return torch.cat(out)


def correspondences(f_src: torch.Tensor, f_dst: torch.Tensor) -> torch.Tensor:
    """``(m, 2)`` mutual nearest neighbours ``(i, j)``, sorted by ``i``."""
    j_of_i = nearest(f_src, f_dst)
    i_of_j = nearest(f_dst, f_src)
    i = torch.arange(len(f_src), device=f_src.device)
    keep = i_of_j[j_of_i] == i
    return torch.stack([i[keep], j_of_i[keep]], dim=1)


def _max_independent(conflicts: dict, max_nodes: int):
    """A largest set of the keys of ``conflicts`` (vertex -> the set of
    vertices it conflicts with, symmetric) with no conflict inside it; None
    past ``max_nodes`` nodes of the search.

    A vertex of at most one conflict is taken (some largest set holds it);
    components are solved apart; else the vertex of the most conflicts
    (ties to the lowest) is taken, then left out where a greedy matching's
    bound leaves room for a larger set."""
    nodes = 0

    def bound(vs: set) -> int:
        free, matched = set(vs), 0
        for v in sorted(vs):
            if v in free:
                free.discard(v)
                mate = min(conflicts[v] & free, default=None)
                if mate is not None:
                    free.discard(mate)
                    matched += 1
        return len(vs) - matched

    def walk(vs: set) -> list:
        nonlocal nodes
        nodes += 1
        if nodes > max_nodes:
            raise OverflowError
        vs, taken = set(vs), []
        changed = True
        while changed:
            changed = False
            for v in sorted(vs):
                if v in vs and len(conflicts[v] & vs) <= 1:
                    taken.append(v)
                    vs -= conflicts[v] | {v}
                    changed = True
        if not vs:
            return taken
        comp, front = {min(vs)}, [min(vs)]
        while front:
            nxt = set().union(*(conflicts[u] & vs for u in front)) - comp
            comp |= nxt
            front = list(nxt)
        if comp != vs:
            return taken + walk(comp) + walk(vs - comp)
        top = max(sorted(vs), key=lambda u: len(conflicts[u] & vs))
        best = walk(vs - conflicts[top] - {top}) + [top]
        rest = vs - {top}
        if bound(rest) > len(best):
            other = walk(rest)
            if len(other) > len(best):
                best = other
        return taken + best

    try:
        return sorted(walk(set(conflicts)))
    except OverflowError:
        return None


def peel(adj: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """``(n,)`` bool clique from the vertex set ``members``: the member
    missing the most edges to the rest leaves (ties to the lowest) until
    none misses one."""
    idx = torch.nonzero(members).flatten()
    missing = ~adj[idx][:, idx]
    missing.fill_diagonal_(False)
    count = missing.sum(dim=1)
    gone = torch.zeros_like(members[idx])
    while True:
        j = int(torch.argmax(torch.where(gone, -1, count)))
        if bool(gone[j]) or int(count[j]) == 0:
            break
        gone[j] = True
        count -= missing[:, j].to(count.dtype)
    out = torch.zeros_like(members)
    out[idx[~gone]] = True
    return out


def max_clique(adj: torch.Tensor, deg0: torch.Tensor, max_nodes: int = 200_000):
    """``(inliers (n,) bool, decided bool)``: the maximum clique of one
    problem's ``(n, n)`` graph.

    The top core, where it is a clique (``registration.py``'s
    certificate). Else a clique of ``L`` vertices peeled from the top core
    bounds the search: every larger clique lies in the ``L``-core, and the
    largest clique of the ``L``-core is its vertices less a least cover of
    the edges it misses, that is those that miss none and a largest
    independent set of the conflict graph of the misses, found exactly.
    Undecided where the misses are not sparse (more than 8 a vertex that
    has one, on average) or the search passes ``max_nodes`` nodes."""
    core = known.top_core(adj[None], deg0[None])[0]
    if bool(known.is_clique(adj[None], core[None])[0]):
        return core, True
    clique = peel(adj, core)
    size = int(clique.sum())
    c_set = known.k_core(adj[None], deg0[None], torch.tensor([size], device=adj.device))[0]
    members = torch.nonzero(c_set).flatten()
    missing = ~adj[members][:, members]
    missing.fill_diagonal_(False)
    if int(missing.sum()) > 2 * 8 * int(missing.any(dim=1).sum()):
        return clique, False  # no near-clique: the search below is for sparse misses
    rows, cols = (x.tolist() for x in torch.nonzero(missing, as_tuple=True))
    conflicts = {}
    for r, c in zip(rows, cols):
        conflicts.setdefault(r, set()).add(c)
    keep = _max_independent(conflicts, max_nodes)
    if keep is None:
        return clique, False
    best = c_set.clone()
    best[members[sorted(set(conflicts) - set(keep))]] = False
    return (best if int(best.sum()) > size else clique), True


def solve(src: torch.Tensor, dst: torch.Tensor, solver: dict,
          dtype: torch.dtype = torch.float64, graph_dtype: torch.dtype = torch.float32
          ) -> Reference:
    """The reference registration of ``(P, 3, n)`` pairs of raw clouds on
    their device.

    ``solver`` holds the configuration's ``frontend`` group (the two radii;
    the matcher's flags, of which this reference runs cross-check without
    the tuple test) and the solve's ``noise_bound``, ``cbar2`` and
    ``rotation_*`` keys. The front end and the graph run in
    ``graph_dtype``, the rotation and translation in ``dtype``, as
    ``registration.solve``'s do; the inliers are over the source cloud's
    ``n`` points."""
    fe = solver["frontend"]
    if not fe["use_crosscheck"] or fe["use_tuple_test"]:
        raise ValueError("this reference runs the matcher with cross-check and no tuple test")
    radii = (fe["normal_search_radius"], fe["fpfh_search_radius"])
    nb = solver["noise_bound"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for p in range(src.shape[0]):
            corr = correspondences(descriptors(src[p], radii, graph_dtype),
                                   descriptors(dst[p], radii, graph_dtype))
            ci, cj = corr[:, 0], corr[:, 1]
            s, d = src[p][None][..., ci], dst[p][None][..., cj]
            adj = known.trim_adjacency(s, d, 2.0 * nb * math.sqrt(solver["cbar2"]),
                                       graph_dtype)
            clique, decided = max_clique(adj[0], known.degrees(adj)[0])
            del adj
            sx, dx = s.to(dtype), d.to(dtype)
            rot = known.gnc_tls_rotation(
                known.chain_tims(sx, clique[None]), known.chain_tims(dx, clique[None]),
                clique[None], 2.0 * nb, solver["rotation_gnc_factor"],
                solver["rotation_max_iterations"], solver["rotation_cost_threshold"])
            t = known.tls_translation(dx - torch.einsum("pij,pjn->pin", rot, sx), clique[None],
                                      nb * math.sqrt(solver["cbar2"]))
            inl = torch.zeros((1, src.shape[-1]), dtype=torch.bool, device=src.device)
            inl[0, ci[clique]] = True
            one = torch.ones(1, dtype=torch.float64, device=src.device)
            out.append(Reference(rot.to(torch.float64), t.to(torch.float64), one, inl,
                                 torch.tensor([decided], device=src.device)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return Reference(*(torch.cat(f) for f in zip(*out)))
