"""Ray sampling: stratified coarse samples and inverse-CDF importance
samples; port of nefes_tpu/render/sampling.py (reference
script/models/rendering.py:23-66, 96-141). The JAX package's
comparison-matrix searchsorted/gather/sort are a TPU idiom; here they are
torch.searchsorted, torch.gather and torch.sort, with the same results."""

from __future__ import annotations

import torch


class RowShard:
    """A generator for one shard of a batch of rays (parallel/train_dp.py):
    a draw of shape (R, ...) is the rows `rows` (R,) of the same draw for
    the batch's n_rows rays, so that a rank's rays take the values the
    unsharded render draws for them, and every rank's gen stays in one
    state."""

    def __init__(self, gen: torch.Generator, rows: torch.Tensor,
                 n_rows: int):
        self.gen, self.rows, self.n_rows = gen, rows, n_rows

    @property
    def device(self) -> torch.device:
        return self.gen.device


def base_generator(rng):
    """The torch.Generator behind rng (a RowShard's own), or None."""
    return rng.gen if isinstance(rng, RowShard) else rng


def draw(rng, shape, device, normal: bool = False) -> torch.Tensor:
    """torch.rand (torch.randn when normal) of shape from rng, on device;
    from a RowShard, its rows of the whole batch's draw."""
    fn = torch.randn if normal else torch.rand
    if isinstance(rng, RowShard):
        if shape[0] != rng.rows.shape[0]:
            raise ValueError(f"a draw of {shape[0]} rows from a shard of "
                             f"{rng.rows.shape[0]}")
        full = fn((rng.n_rows, *shape[1:]), generator=rng.gen,
                  device=rng.gen.device)
        return full.index_select(0, rng.rows).to(device)
    return fn(shape, generator=rng, device=rng.device).to(device)


def _bound(v, n_rays: int, device) -> torch.Tensor:
    """A near or far bound as (n_rays, 1) f32; a Python number is filled
    on the device (no host copy, so the render can be captured as a CUDA
    graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).expand(n_rays, 1)
    return torch.full((n_rays, 1), float(v), device=device)


def stratified_samples(rng: torch.Generator | None, n_rays: int,
                       n_samples: int, near, far, lindisp: bool = False,
                       perturb: bool = True, device="cuda") -> torch.Tensor:
    """(n_rays, n_samples) z values in [near, far]; near/far are scalars
    or (n_rays, 1). perturb jitters each sample inside its interval; with
    rng None or perturb False the grid is deterministic."""
    t = torch.linspace(0.0, 1.0, n_samples, device=device)
    near, far = (_bound(v, n_rays, device) for v in (near, far))
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    if perturb and rng is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        u = draw(rng, z.shape, device)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(rng: torch.Generator | None, bins: torch.Tensor,
               weights: torch.Tensor, n_samples: int, det: bool = False,
               u_override: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples new z values per ray.

    bins (R, B+1) bin edges, weights (R, B). Keeps the reference's +1e-5
    weight floor, right-searchsorted on the detached CDF and the <1e-5
    denominator guard; u_override injects the uniforms (parity tests)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = cdf.shape[:-1] + (n_samples,)
    if u_override is not None:
        u = u_override
    elif det or rng is None:
        u = torch.linspace(0.0, 1.0, n_samples,
                           device=cdf.device).expand(shape)
    else:
        u = draw(rng, shape, cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def hierarchical_samples(rng: torch.Generator | None, z_vals: torch.Tensor,
                         weights: torch.Tensor, n_importance: int,
                         det: bool = False,
                         combine: bool = True) -> torch.Tensor:
    """PDF-sample n_importance extra z values from the coarse weights
    (detached) and return them, sorted, with the coarse z values unless
    combine is False (use_fine_only)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_new = sample_pdf(rng, z_mid, weights[..., 1:-1], n_importance,
                       det=det).detach()
    if not combine:
        return torch.sort(z_new, dim=-1).values
    return torch.sort(torch.cat([z_vals, z_new], dim=-1), dim=-1).values
