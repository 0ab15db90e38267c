"""Plain reference of certified registration, in PyTorch: TEASER++'s
known-scale registration, then upstream's DRS optimality certifier on its
rotation stage.

A user who needs a guarantee calls ``RobustRegistrationSolver::solve``,
then ``DRSCertifier::certify(R, src_tims, dst_tims, theta)`` (upstream
``teaser/src/certification.cc``; ``teaser/include/teaser/certification.h``)
on the rotation it found, the rotation stage's TIMs and its +-1 inlier
vector; ``solve`` never calls it. Here:

* the registration is the known-scale reference's (``registration.py``,
  imported and not copied): the maximum clique of the TRIM graph, the
  chain TIMs over it, GNC-TLS at the noise bound ``2 noise_bound``, the TLS
  translation;
* the certificate is taken on the clique's cyclic chain TIMs in index
  order, differenced in the certifier's precision; on theta, +1 where the
  GNC's final weight is 0.5 or more (upstream registration.cc:861-865),
  -1 elsewhere (``registration.py`` returns no weights: :func:`gnc_weights`
  runs its loop again and keeps them); and on the noise bound the rotation
  stage used, ``2 noise_bound``, with the configuration's ``certifier``
  group: ``cbar2``, ``sub_optimality``, ``max_iterations``, ``gamma_tau``
  (upstream's ``DRSCertifier::Params``, DENSE);
* the DRS loop runs one problem at a time, each step a function below named
  with its lines of ``certification.cc``: the Q cost, Omega_1 and D_omega,
  the primal cost ``mu = x^T Q x``, the KKT guess of the dual, the inverse
  map A^-1 as a sparse matrix of upstream's triplets, the dual projection,
  the nearest PSD matrix by ``torch.linalg.eigh``, the gap from the least
  eigenvalue, and ``M += gamma_tau (M_affine - M_PSD)``, stopping once a gap
  is below ``sub_optimality``; ``best`` is the least gap seen, ``optimal``
  whether it is below ``sub_optimality``.

Precision: the registration in ``dtype`` after a ``graph_dtype`` graph, as
``registration.py`` says; the certificate in ``dtype``, float32 at least,
since PyTorch has no ``eigh`` below it (the control's bfloat16 runs it in
float32).

Departures from upstream:

* the quaternion of R is Eigen's ``Quaterniond(R)`` conversion, normalised,
  read in Python floats (upstream converts in double as well);
* a problem whose clique has fewer than two points has no TIMs: it is
  reported not optimal with an infinite gap, and not certified;
* the 9 x 16 map from ``vec(q q^T)`` to ``vec(R)`` is built from the
  quaternion's rotation matrix, each cross term split evenly between its
  two entries, which is upstream's table (certification.cc:241-252).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# The harness loads a reference by its file, as a module of no package; name
# the package so that the known-scale reference is found beside this one.
if not __package__:
    __package__ = "regbench.reference"
from . import registration as known  # noqa: E402


class Certified(NamedTuple):
    rotation: torch.Tensor  # (P, 3, 3) float64
    translation: torch.Tensor  # (P, 3) float64
    scale: torch.Tensor  # (P,) float64: 1, the configuration's known scale
    inliers: torch.Tensor  # (P, n) bool: the selected clique
    decided: torch.Tensor  # (P,) bool: the top core is a clique
    optimal: torch.Tensor  # (P,) bool: the certifier's verdict
    suboptimality: torch.Tensor  # (P,) float64: its best gap


def gnc_weights(x, y, valid, noise_bound: float, gnc_factor: float, max_iterations: int,
                cost_threshold: float) -> torch.Tensor:
    """``(P, n)`` final TLS weights of ``registration.gnc_tls_rotation``'s
    loop on the same arguments: the loop again, its weights kept. A problem
    whose first round gives ``mu <= 0`` keeps its first weights, the valid
    flags, as upstream breaks before it updates them."""
    p = x.shape[0]
    dt = x.dtype
    vf = valid.to(dt)
    nb2 = torch.tensor(noise_bound * noise_bound, dtype=dt, device=x.device)
    w = vf.clone()
    mu = torch.ones(p, 1, dtype=dt, device=x.device)
    prev = torch.full((p,), float("inf"), dtype=dt, device=x.device)
    running = torch.ones(p, dtype=torch.bool, device=x.device)
    for it in range(max_iterations):
        r = known.weighted_procrustes(x, y, w)
        res = y - torch.einsum("pij,pjn->pin", r, x)
        r2 = (res * res).sum(dim=1) * vf
        if it == 0:
            mu = 1.0 / (2.0 * r2.amax(dim=-1, keepdim=True) / nb2 - 1.0)
            running = running & (mu[:, 0] > 0)
        th1 = (mu + 1.0) / mu * nb2
        th2 = mu / (mu + 1.0) * nb2
        cost = (w * r2).sum(dim=-1)
        mid = torch.sqrt(nb2 * mu * (mu + 1.0) / r2.clamp(min=1e-30)) - mu
        new_w = torch.where(r2 >= th1, torch.zeros_like(w),
                            torch.where(r2 <= th2, torch.ones_like(w), mid)) * vf
        w = torch.where(running[:, None], new_w, w)
        running = running & ~((cost - prev).abs() < cost_threshold)
        prev = cost
        mu = mu * gnc_factor
        if not bool(running.any()):
            break
    return w


def quaternion_map(dtype, device) -> torch.Tensor:
    """The 9 x 16 ``P`` with ``vec(R(q)) = P vec(q q^T)``, both vectors
    column-major and q = (x, y, z, w) (certification.cc:241-252)."""
    x, y, z, w = range(4)
    # R(q) as sums of coefficient * q_a q_b
    terms = {
        (0, 0): [(1, w, w), (1, x, x), (-1, y, y), (-1, z, z)],
        (0, 1): [(2, x, y), (-2, w, z)], (0, 2): [(2, x, z), (2, w, y)],
        (1, 0): [(2, x, y), (2, w, z)],
        (1, 1): [(1, w, w), (-1, x, x), (1, y, y), (-1, z, z)],
        (1, 2): [(2, y, z), (-2, w, x)],
        (2, 0): [(2, x, z), (-2, w, y)], (2, 1): [(2, y, z), (2, w, x)],
        (2, 2): [(1, w, w), (-1, x, x), (-1, y, y), (1, z, z)],
    }
    p = torch.zeros(9, 16, dtype=dtype, device=device)
    for (i, j), coeffs in terms.items():
        for c, a, b in coeffs:
            if a == b:
                p[i + 3 * j, a + 4 * a] += c
            else:  # split evenly between (a, b) and (b, a)
                p[i + 3 * j, a + 4 * b] += c / 2
                p[i + 3 * j, b + 4 * a] += c / 2
    return p


def _blocks(m: torch.Tensor) -> torch.Tensor:
    """``(4 n1, 4 n1)`` -> the ``(n1, n1, 4, 4)`` view, ``[i, j]`` block (i, j)."""
    n1 = m.shape[-1] // 4
    return m.reshape(n1, 4, n1, 4).transpose(1, 2)


def q_cost(v1: torch.Tensor, v2: torch.Tensor, noise_bound: float,
           cbar2: float) -> torch.Tensor:
    """QUASAR's ``(4N + 4)^2`` cost matrix Q of ``(3, N)`` TIMs
    (certification.cc:233-299): Q1's blocks (0, k) and (k, 0) are ``-P_k / 2
    + c_k / 2 I`` with ``c_k = (|v1_k|^2 + |v2_k|^2 - cbar2 nb^2) / 2``, Q2's
    block (k, k) is ``-P_k + c'_k I`` with ``+ cbar2 nb^2`` in ``c'_k``, and
    ``P_k`` the column-major 4 x 4 of ``P^T vec(v2_k v1_k^T)``."""
    n = v1.shape[-1]
    nbs = cbar2 * noise_bound * noise_bound
    p = quaternion_map(v1.dtype, v1.device)
    a = v2.T[:, :, None] * v1.T[:, None, :]  # (N, 3, 3): v2_k v1_k^T
    p_k = (a.transpose(1, 2).reshape(n, 9) @ p).reshape(n, 4, 4).transpose(1, 2)
    sq = (v1 * v1).sum(0) + (v2 * v2).sum(0)
    eye = torch.eye(4, dtype=v1.dtype, device=v1.device)
    q = torch.zeros(4 * n + 4, 4 * n + 4, dtype=v1.dtype, device=v1.device)
    qb = _blocks(q)  # a view: writes land in q
    k = torch.arange(1, n + 1, device=v1.device)
    off = -0.5 * p_k + (0.5 * (sq - nbs) / 2)[:, None, None] * eye
    qb[0, k] = off
    qb[k, 0] = off
    qb[k, k] = -p_k + (0.5 * (sq + nbs))[:, None, None] * eye
    return q


def quaternion(r) -> list:
    """Eigen's ``Quaterniond(R)``, normalised, as ``[x, y, z, w]``."""
    m = [[float(r[i][j]) for j in range(3)] for i in range(3)]
    q = [0.0] * 4
    t = m[0][0] + m[1][1] + m[2][2]
    if t > 0:
        t = math.sqrt(t + 1.0)
        q[3] = 0.5 * t
        t = 0.5 / t
        q[0] = (m[2][1] - m[1][2]) * t
        q[1] = (m[0][2] - m[2][0]) * t
        q[2] = (m[1][0] - m[0][1]) * t
    else:
        i = 0
        if m[1][1] > m[0][0]:
            i = 1
        if m[2][2] > m[i][i]:
            i = 2
        j, k = (i + 1) % 3, (i + 2) % 3
        t = math.sqrt(m[i][i] - m[j][j] - m[k][k] + 1.0)
        q[i] = 0.5 * t
        t = 0.5 / t
        q[3] = (m[k][j] - m[j][k]) * t
        q[j] = (m[j][i] + m[i][j]) * t
        q[k] = (m[k][i] + m[i][k]) * t
    norm = math.sqrt(sum(c * c for c in q))
    return [c / norm for c in q]


def omega_1(q: list, dtype, device) -> torch.Tensor:
    """The 4 x 4 Omega_1 of a quaternion (certification.cc:301-310)."""
    x, y, z, w = q
    return torch.tensor([[w, -z, y, x], [z, w, -x, y], [-y, x, w, z], [-x, -y, -z, w]],
                        dtype=dtype, device=device)


def block_diag_omega(npm: int, q: list, dtype, device) -> torch.Tensor:
    """D_omega: Omega_1 on each of the ``npm / 4`` diagonal blocks
    (certification.cc:312-321)."""
    return torch.block_diag(*[omega_1(q, dtype, device)] * (npm // 4))


def hat(v: torch.Tensor) -> torch.Tensor:
    """``(N, 3)`` -> ``(N, 3, 3)`` hat maps, ``hat(a) b = a x b``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def lambda_guess(r: torch.Tensor, theta: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                 noise_bound: float, cbar2: float) -> torch.Tensor:
    """The KKT guess of the dual (certification.cc:454-536): for each TIM
    the 4 x 4 block of its residual ``xi = R^T (v2_k - R v1_k)``, the
    inlier's (theta > 0) factors 0.75 and 0.25, the outlier's 0.25 and
    0.75, and -1.5 or -0.5 on ``hat(xi) v1_k``; each block negated on its
    diagonal place, their sum on block (0, 0)."""
    n = v1.shape[-1]
    nbs = cbar2 * noise_bound * noise_bound
    s = v1.T  # (N, 3)
    xi = (r.T @ (v2 - r @ v1)).T
    xi2 = (xi * xi).sum(-1)
    inl = theta > 0
    a = torch.where(inl, 0.75, 0.25).to(v1.dtype)
    b = torch.where(inl, 0.25, 0.75).to(v1.dtype)
    eye = torch.eye(3, dtype=v1.dtype, device=v1.device)
    hs, hx = hat(s), hat(xi)
    blk = torch.zeros(n, 4, 4, dtype=v1.dtype, device=v1.device)
    blk[:, :3, :3] = (hs @ hs - 0.5 * (s * xi).sum(-1)[:, None, None] * eye + 0.5 * (hx @ hs)
                      + 0.5 * xi[:, :, None] * s[:, None, :]
                      - (a * xi2)[:, None, None] * eye - 0.25 * nbs * eye)
    vec = torch.where(inl, -1.5, -0.5).to(v1.dtype)[:, None] * (hx @ s[:, :, None])[..., 0]
    blk[:, :3, 3] = vec
    blk[:, 3, :3] = vec
    blk[:, 3, 3] = -a * xi2 - b * nbs
    lam = torch.zeros(4 * n + 4, 4 * n + 4, dtype=v1.dtype, device=v1.device)
    lb = _blocks(lam)
    k = torch.arange(1, n + 1, device=v1.device)
    lb[k, k] = -blk
    lb[0, 0] = blk.sum(0)
    return lam


def _pair(a: torch.Tensor, b: torch.Tensor, n1: int) -> torch.Tensor:
    """Index of the pair ``a < b`` in the row-major upper triangle of ``n1``."""
    return a * n1 - a * (a + 1) // 2 + (b - a - 1)


def inverse_map(theta_prepended: torch.Tensor) -> torch.Tensor:
    """The sparse ``A^-1`` over the block pairs ``i < j`` of ``N + 1``
    blocks, upstream's triplets (certification.cc:538-657): ``x = (N + 1) y``
    on the diagonal, ``y = 1 / (2 N + 6)``, and for each column ``(i, j)``
    and each ``p`` apart from both, two entries by where ``p`` lies."""
    th = theta_prepended
    n1 = th.numel()
    y = 1.0 / (2.0 * (n1 - 1) + 6.0)
    x = n1 * y
    i, j = torch.triu_indices(n1, n1, offset=1, device=th.device)
    col = _pair(i, j, n1)
    p = torch.arange(n1, device=th.device)
    ii, jj, pp = (t.expand(len(col), n1) for t in (i[:, None], j[:, None], p[None, :]))
    cc = col[:, None].expand(len(col), n1)
    keep = (pp != ii) & (pp != jj)
    # rows: p < i: (p, i) and (p, j); i < p < j: (i, p) and (p, j); p > j:
    # (i, p) and (j, p); entries +-y theta_j theta_p and +-y theta_i theta_p,
    # + for the first where p < i, for the second where p > j
    row1 = _pair(torch.minimum(pp, ii), torch.maximum(pp, ii), n1)
    row2 = _pair(torch.minimum(pp, jj), torch.maximum(pp, jj), n1)
    val1 = y * torch.where(pp < ii, th[jj], -th[jj]) * th[pp]
    val2 = y * torch.where(pp > jj, th[ii], -th[ii]) * th[pp]
    k = len(col)
    rows = torch.cat([row1[keep], row2[keep], col])
    cols = torch.cat([cc[keep], cc[keep], col])
    vals = torch.cat([val1[keep], val2[keep], torch.full((k,), x, dtype=th.dtype,
                                                          device=th.device)])
    with torch.sparse.check_sparse_tensor_invariants():
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (k, k)).coalesce()


def dual_projection(w: torch.Tensor, theta_prepended: torch.Tensor,
                    a_inv: torch.Tensor) -> torch.Tensor:
    """The projection of ``w`` onto the dual's structure
    (certification.cc:323-452): each off-diagonal block (i, j), i < j, its
    skew part with the last column and row ``A^-1 b_W`` (and minus it); the
    lower blocks their transposes; each diagonal block ``w``'s own with its
    last column and row ``-theta_i sum_j theta_j W_dual[4i:4i+4, 4j+3]``,
    less the mean over the diagonal blocks of their top-left 3 x 3."""
    th = theta_prepended
    n1 = th.numel()
    wb = _blocks(w)
    i, j = torch.triu_indices(n1, n1, offset=1, device=w.device)
    tij = (th[i] * th[j])[:, None]
    row3 = wb[:, :, 3, :3]  # [i, j] = W[4i + 3, 4j:4j + 3]
    b_w = -tij * row3[i, i] + row3[j, i] - row3[i, j] + tij * row3[j, j]
    b_dual = a_inv @ b_w
    wij = wb[i, j]
    d = (wij - wij.transpose(1, 2)) / 2
    d[:, :3, 3] = b_dual
    d[:, 3, :3] = -b_dual
    d[:, 3, 3] = 0.0
    out = torch.zeros_like(w)
    _blocks(out)[i, j] = d
    out = out + out.T
    ob = _blocks(out)
    last = -th[:, None] * (ob[:, :, :, 3] * th[None, :, None]).sum(1)  # (n1, 4)
    k = torch.arange(n1, device=w.device)
    wii = wb[k, k].clone()
    wii[:, :, 3] = last
    wii[:, 3, :] = last
    wii[:, :3, :3] -= wii[:, :3, :3].mean(0)
    ob[k, k] = wii
    return out


def nearest_psd(m: torch.Tensor) -> torch.Tensor:
    """The nearest PSD matrix: the symmetric part with its negative
    eigenvalues set to 0 (upstream ``getNearestPSD``, linalg.h)."""
    e, v = torch.linalg.eigh((m + m.T) / 2)
    return (v * e.clamp(min=0.0)) @ v.T


def suboptimality_gap(m: torch.Tensor, mu: float, n: int) -> float:
    """``-lambda_min (N + 1) / mu`` of the symmetric part, 0 where
    ``lambda_min > 0`` (certification.cc:192-231)."""
    lam = float(torch.linalg.eigvalsh((m + m.T) / 2)[0])
    return 0.0 if lam > 0 else (-lam * (n + 1)) / mu


def certify(r: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor, theta: torch.Tensor,
            noise_bound: float, cert: dict) -> tuple:
    """``(optimal, best gap, gaps)`` of ``DRSCertifier::certify`` on one
    problem's ``(3, N)`` TIMs (certification.cc:39-190)."""
    n = v1.shape[-1]
    npm = 4 * n + 4
    dt, dev = v1.dtype, v1.device
    th = torch.cat([torch.ones(1, dtype=dt, device=dev), theta.to(dt)])
    a_inv = inverse_map(th)
    q_mat = q_cost(v1, v2, noise_bound, cert["cbar2"])
    q = quaternion(r.tolist())
    x = torch.kron(th, torch.tensor(q, dtype=dt, device=dev))
    d = block_diag_omega(npm, q, dt, dev)
    q_bar = d.T @ (q_mat @ d)
    mu = float(x @ (q_mat @ x))  # the primal cost (certification.cc:92)
    m_init = q_bar - lambda_guess(r.to(dt), theta, v1, v2, noise_bound, cert["cbar2"])
    m_init[:4, :4] -= mu * torch.eye(4, dtype=dt, device=dev)
    m = m_init.clone()
    gaps = []
    for _ in range(cert["max_iterations"]):  # certification.cc:126-182
        m_psd = nearest_psd(m)
        m_affine = m_init + dual_projection(2.0 * m_psd - m - m_init, th, a_inv)
        gaps.append(suboptimality_gap(m_affine, mu, n))
        if gaps[-1] < cert["sub_optimality"]:
            break
        m = m + cert["gamma_tau"] * (m_affine - m_psd)
    best = min(gaps)
    return best < cert["sub_optimality"], best, gaps


def solve(src: torch.Tensor, dst: torch.Tensor, solver: dict,
          dtype: torch.dtype = torch.float64,
          graph_dtype: torch.dtype = torch.float32) -> Certified:
    """The reference registration of ``(P, 3, n)`` problems on their device
    and the certificate of each.

    ``solver`` holds what ``registration.solve`` reads and the
    ``certifier`` group. The registration runs as ``registration.solve``
    says; the certificate in ``dtype``, float32 at least.
    """
    reg = known.solve(src, dst, solver, dtype=dtype, graph_dtype=graph_dtype)
    nb_rot = 2.0 * solver["noise_bound"]
    cert = solver["certifier"]
    inl = reg.inliers
    sx, dx = src.to(dtype), dst.to(dtype)
    w = gnc_weights(known.chain_tims(sx, inl), known.chain_tims(dx, inl), inl, nb_rot,
                    solver["rotation_gnc_factor"], solver["rotation_max_iterations"],
                    solver["rotation_cost_threshold"])
    cdt = torch.promote_types(dtype, torch.float32)
    v1s = known.chain_tims(src.to(cdt), inl)
    v2s = known.chain_tims(dst.to(cdt), inl)
    optimal, subopt = [], []
    for p in range(src.shape[0]):
        sel = inl[p]
        if int(sel.sum()) < 2:
            optimal.append(False)
            subopt.append(math.inf)
            continue
        ok, best, _ = certify(reg.rotation[p].to(cdt), v1s[p][:, sel], v2s[p][:, sel],
                              torch.where(w[p][sel] >= 0.5, 1.0, -1.0).to(cdt), nb_rot, cert)
        optimal.append(ok)
        subopt.append(best)
    dev = src.device
    return Certified(*reg, torch.tensor(optimal, dtype=torch.bool, device=dev),
                     torch.tensor(subopt, dtype=torch.float64, device=dev))
