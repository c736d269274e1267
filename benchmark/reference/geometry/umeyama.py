"""Batched, masked Umeyama similarity fit + vectorised RANSAC
(counterpart of `mot3d_tpu/geometry/umeyama.py`).

Reference behaviour: `PoseEst/pose_utils.py`.
  - estimateSimilarityUmeyama (:16-61): centred 3x3 covariance -> rotation
    with reflection handling; isotropic scale = sum(D) / var(source);
    translation t = mu_t - s * R^T mu_s, where the returned "rotation" is
    R = (U V^T)^T (the reference's convention).
  - getRANSACInliers (:63-83): 100 hypotheses x 10-point minimal sets,
    scored by the Frobenius residual over all points, best-so-far early stop
    at StopThreshold, inliers = residual < PassThreshold.
  - estimateSimilarityTransform (:86-117): auto thresholds from mean norms;
    fails below a 0.1 inlier ratio; final Umeyama on the inliers.

Every function takes leading batch dimensions (one per detection slot), so
all hypotheses of all slots of a sequence are one batched pass.  RANSAC
takes its random draws as an input: `draws` (..., iters, S) raw
non-negative integers, used as rank = u % n_valid exactly as the JAX package
uses its `jax.random.randint` draws.  Callers without draws make them with a
`torch.Generator` (`make_draws`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.precision import strict_fp32

INT32_MAX = 2 ** 31 - 1


class SimilarityTransform(NamedTuple):
    scale: torch.Tensor        # (...,) isotropic scale
    rotation: torch.Tensor     # (..., 3, 3) reference-convention R
    translation: torch.Tensor  # (..., 3)
    valid: torch.Tensor        # (...,) bool — solver succeeded


def make_draws(shape, generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """Raw RANSAC draws in [0, 2^31 - 1), the range of the JAX package's
    `randint(key, (iters, S), 0, int32max)`."""
    return torch.randint(0, INT32_MAX, tuple(shape), generator=generator,
                         device=device, dtype=torch.int64)


def _horn_rstar(cov: torch.Tensor) -> torch.Tensor:
    """Optimal source->target rotation r* (..., 3, 3) from the covariance
    (..., 3, 3) (target x source).

    Horn's quaternion method: the top eigenvector of the symmetric 4x4
    K(cov) is the optimal unit quaternion.  A trace shift makes its
    eigenvalue dominant in magnitude and K^(2^6) q0 extracts it by six
    Frobenius-normalised squarings (the JAX package's power iteration,
    `_horn_rstar_scalars`).  An all-zero covariance is replaced by the
    identity first.  Always a proper rotation."""
    s = cov.transpose(-1, -2)
    ss = (s * s).sum((-1, -2))
    eye3 = torch.eye(3, dtype=cov.dtype, device=cov.device)
    s = torch.where((ss > 0)[..., None, None], s, eye3)
    tr = s[..., 0, 0] + s[..., 1, 1] + s[..., 2, 2]
    shift = 2.0 * torch.sqrt((s * s).sum((-1, -2))) + 1e-12
    s00, s01, s02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s10, s11, s12 = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    s20, s21, s22 = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    rows = [[tr + shift, s12 - s21, s20 - s02, s01 - s10],
            [None, s00 - s11 - s22 + shift, s01 + s10, s20 + s02],
            [None, None, s11 - s00 - s22 + shift, s12 + s21],
            [None, None, None, s22 - s00 - s11 + shift]]
    for i in range(4):
        for j in range(i):
            rows[i][j] = rows[j][i]
    m = torch.stack([torch.stack(r, -1) for r in rows], -2)

    for _ in range(6):
        m = m @ m
        f2 = (m * m).sum((-1, -2))
        fpos = f2 > 0
        fro = torch.where(fpos, torch.sqrt(torch.where(fpos, f2,
                                                       torch.ones_like(f2))),
                          torch.zeros_like(f2))
        m = m * (1.0 / torch.clamp(fro, min=1e-15))[..., None, None]

    q = m.sum(-1)
    q2 = (q * q).sum(-1)
    qpos = q2 > 0
    qn = 1.0 / torch.clamp(torch.where(
        qpos, torch.sqrt(torch.where(qpos, q2, torch.ones_like(q2))),
        torch.zeros_like(q2)), min=1e-15)
    w, x, y, z = (q * qn[..., None]).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _scale(trace: torch.Tensor, var_s: torch.Tensor) -> torch.Tensor:
    degenerate = (var_s * trace) == 0.0
    return torch.where(degenerate, torch.ones_like(trace),
                       trace / torch.clamp(var_s, min=1e-12))


@strict_fp32()
def umeyama_similarity(source: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor,
                       method: str = "quat") -> SimilarityTransform:
    """Weighted Umeyama fit source -> target; (..., N, 3) points and
    (..., N) non-negative weights (0 = padded).  Biased (1/N) moments,
    fallback scale 1 when var or trace is zero.  method: "quat" (Horn
    quaternion) or "svd" (torch.linalg.svd with the reflection fix)."""
    w = weights.to(source.dtype)
    n = torch.clamp(w.sum(-1), min=1e-12)
    mu_s = (source * w[..., None]).sum(-2) / n[..., None]
    mu_t = (target * w[..., None]).sum(-2) / n[..., None]
    cs = source - mu_s[..., None, :]
    ct = (target - mu_t[..., None, :]) * w[..., None]
    cov = (ct.transpose(-1, -2) @ cs) / n[..., None, None]
    if method == "quat":
        r_star = _horn_rstar(cov)
        trace = (r_star * cov).sum((-1, -2))
    elif method == "svd":
        u, d, vt = torch.linalg.svd(cov)
        neg = (torch.linalg.det(u) * torch.linalg.det(vt)) < 0.0
        sign = torch.ones_like(d)
        sign[..., 2] = torch.where(neg, -1.0, 1.0)
        r_star = (u * sign[..., None, :]) @ vt
        trace = (d * sign).sum(-1)
    else:
        raise ValueError(f"unknown Umeyama method {method!r}")
    var_s = (cs ** 2 * w[..., None]).sum((-1, -2)) / n
    scale = _scale(trace, var_s)
    rotation = r_star.transpose(-1, -2)
    translation = mu_t - scale[..., None] * (r_star @ mu_s[..., None])[..., 0]
    return SimilarityTransform(scale, rotation, translation,
                               torch.ones_like(scale, dtype=torch.bool))


def _compaction_table(valid: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N) indices of the valid points in raster order,
    then zeros (the JAX package's `valid_idx_table`)."""
    n = valid.shape[-1]
    slot = torch.where(valid, torch.cumsum(valid.long(), -1) - 1,
                       torch.full_like(valid, n, dtype=torch.long))
    table = torch.zeros(valid.shape[:-1] + (n + 1,), dtype=torch.long,
                        device=valid.device)
    idx = torch.arange(n, device=valid.device).expand(valid.shape)
    return table.scatter(-1, slot, idx)[..., :n]


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, 3), idx (..., H, S) -> (..., H, S, 3)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + (3,)))
    return out.reshape(idx.shape + (3,))


@strict_fp32()
def ransac_umeyama(source: torch.Tensor, target: torch.Tensor,
                   valid: torch.Tensor, draws: torch.Tensor,
                   pass_threshold, stop_threshold, method: str = "quat"):
    """Vectorised RANSAC over all hypotheses of all slots.

    source/target (..., N, 3); valid (..., N); draws (..., iters, S) raw
    integers.  Returns (inliers (..., N), ratio (...,)).  Winner: argmin of
    the hypothesis residuals over the prefix ending at the first hypothesis
    whose running best beats `stop_threshold` (the reference's early stop).
    """
    n = source.shape[-2]
    iters, sample_size = draws.shape[-2:]
    n_valid = torch.clamp(valid.sum(-1), min=1)
    rank = draws % n_valid[..., None, None]
    draw = torch.gather(_compaction_table(valid), -1,
                        rank.reshape(rank.shape[:-2] + (-1,))
                        ).reshape(rank.shape)                 # (..., H, S)
    pass_sq = torch.square(pass_threshold)

    if method == "quat":
        # Moment form: every fit statistic is a sum over the drawn multiset,
        # i.e. an (iters, N) selection-count matrix times an (N, 18) feature
        # matrix; scoring is a closed-form quadratic in the fitted transform.
        dt = source.dtype
        v_f = valid.to(dt)
        nv = n_valid.to(dt)
        any_valid = (valid.sum(-1) > 0).to(dt)
        w_sel = torch.zeros(draw.shape[:-1] + (n,), dtype=dt,
                            device=source.device)
        w_sel = w_sel.scatter_add(
            -1, draw, any_valid[..., None, None].expand(draw.shape))

        cs = (source * v_f[..., None]).sum(-2) / nv[..., None]
        ct = (target * v_f[..., None]).sum(-2) / nv[..., None]
        zero = torch.zeros_like(source)
        sx = torch.where(valid[..., None], source - cs[..., None, :], zero)
        tx = torch.where(valid[..., None], target - ct[..., None, :], zero)
        feats = torch.cat([sx, tx, sx * sx,
                           (tx[..., :, None] * sx[..., None, :]).flatten(-2)],
                          -1)                                 # (..., N, 18)
        mom = w_sel @ feats                                   # (..., H, 18)
        s_n = float(sample_size)
        mus = mom[..., 0:3] / s_n
        mut = mom[..., 3:6] / s_n
        cov = (mom[..., 9:18].reshape(mom.shape[:-1] + (3, 3)) / s_n
               - mut[..., :, None] * mus[..., None, :])
        var_s = (mom[..., 6:9] / s_n - mus ** 2).sum(-1)
        rstar = _horn_rstar(cov)
        trace = (rstar * cov).sum((-1, -2))
        scale = _scale(trace, var_s)
        tau = mut - scale[..., None] * (rstar @ mus[..., None])[..., 0]

        # Closed-form residual: sum_n v |r_n|^2 = sum_j c_j - 2 A_j.B_j
        # + A_j M A_j^T with A_j = [s r*_j, tau_j], P = [sx; v] (4, N).
        p_h = torch.cat([sx, v_f[..., None]], -1)             # (..., N, 4)
        m_q = p_h.transpose(-1, -2) @ p_h                     # (..., 4, 4)
        b_q = tx.transpose(-1, -2) @ p_h                      # (..., 3, 4)
        c_q = (tx ** 2).sum(-2)                               # (..., 3)
        a = torch.cat([scale[..., None, None] * rstar, tau[..., None]], -1)
        quad = ((a @ m_q[..., None, :, :]) * a).sum(-1)       # (..., H, 3)
        lin = (a * b_q[..., None, :, :]).sum(-1)
        rsq_total = (c_q[..., None, :] - 2.0 * lin + quad).sum(-1)
        rpos = rsq_total > 0
        model_res = torch.where(
            rpos, torch.sqrt(torch.where(rpos, rsq_total,
                                         torch.ones_like(rsq_total))),
            torch.zeros_like(rsq_total))                      # (..., H)
    elif method == "svd":
        ones = torch.ones(draw.shape, dtype=source.dtype,
                          device=source.device)
        models = umeyama_similarity(_gather_points(source, draw),
                                    _gather_points(target, draw), ones,
                                    method)
        pred = ((models.scale[..., None, None] * source[..., None, :, :])
                @ models.rotation
                + models.translation[..., None, :])           # (..., H, N, 3)
        r = torch.linalg.norm(target[..., None, :, :] - pred, dim=-1)
        r = torch.where(valid[..., None, :], r, torch.zeros_like(r))
        rsq_all = r ** 2
        model_res = torch.sqrt(rsq_all.sum(-1))
    else:
        raise ValueError(f"unknown Umeyama method {method!r}")

    stopped = torch.cummin(model_res, -1).values < stop_threshold[..., None]
    any_stop = stopped.any(-1)
    k = torch.where(any_stop, torch.argmax(stopped.to(torch.uint8), -1),
                    torch.full_like(any_stop, iters - 1, dtype=torch.long))
    considered = torch.arange(iters, device=source.device) <= k[..., None]
    masked = torch.where(considered, model_res,
                         torch.full_like(model_res, torch.inf))
    best = torch.argmin(masked, -1)                           # (...,)

    if method == "quat":
        bi = best[..., None]
        rs_b = torch.gather(rstar, -3, bi[..., None, None].expand(
            best.shape + (1, 3, 3))).squeeze(-3)
        sc_b = torch.gather(scale, -1, bi).squeeze(-1)
        tr_b = (torch.gather(tau, -2, bi[..., None].expand(
            best.shape + (1, 3))).squeeze(-2) + ct
                - sc_b[..., None] * (rs_b @ cs[..., None])[..., 0])
        pred = (sc_b[..., None, None] * (source @ rs_b.transpose(-1, -2))
                + tr_b[..., None, :])
        rsq_best = torch.where(valid, ((target - pred) ** 2).sum(-1),
                               torch.zeros_like(valid, dtype=source.dtype))
    else:
        rsq_best = torch.gather(
            rsq_all, -2, best[..., None, None].expand(
                best.shape + (1, n))).squeeze(-2)
    inliers = (rsq_best < pass_sq[..., None]) & valid
    return inliers, inliers.sum(-1) / n


@strict_fp32()
def estimate_similarity_transform(source: torch.Tensor, target: torch.Tensor,
                                  valid: torch.Tensor, draws: torch.Tensor,
                                  ratio_adapt: float = 1.0,
                                  min_inlier_ratio: float = 0.1,
                                  stop_divisor: float = 100.0,
                                  method: str = "quat"
                                  ) -> SimilarityTransform:
    """Auto thresholds -> RANSAC -> final Umeyama on the inliers
    (`estimateSimilarityTransform`).  source/target (..., N, 3), valid
    (..., N), draws (..., iters, S).  On failure valid=False with the fit
    still populated."""
    n_valid = torch.clamp(valid.sum(-1), min=1)

    def _safe_norms(pts):
        sq = (pts ** 2).sum(-1)
        pos = sq > 0
        return torch.where(pos, torch.sqrt(torch.where(
            pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))

    zeros = torch.zeros_like(valid, dtype=source.dtype)
    norm_s = torch.where(valid, _safe_norms(source), zeros).sum(-1) / n_valid
    norm_t = torch.where(valid, _safe_norms(target), zeros).sum(-1) / n_valid
    ratio_ts = norm_t / torch.clamp(norm_s, min=1e-12)
    ratio_st = norm_s / torch.clamp(norm_t, min=1e-12)
    pass_t = torch.maximum(ratio_st, ratio_ts) * ratio_adapt
    stop_t = pass_t / stop_divisor

    inliers, _ = ransac_umeyama(source, target, valid, draws, pass_t, stop_t,
                                method)
    ratio_valid = inliers.sum(-1) / n_valid
    fit = umeyama_similarity(source, target, inliers.to(source.dtype), method)
    ok = (ratio_valid >= min_inlier_ratio) & \
        (valid.sum(-1) >= draws.shape[-1])
    return SimilarityTransform(fit.scale, fit.rotation, fit.translation, ok)
