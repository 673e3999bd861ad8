"""The flag-selectable alternative fields behind the NeRFH-NFF model's
protocol, so that the training CLI, the trainer and the validation
renders drive any of them; port of nefes_tpu/train/field_zoo.py (the
reference's create_nerf dispatch, script/models/nerfh.py:522-600 and
nerfh_tcnn.py:286-310, selected by --NeRFW / --ffmlp / --tcnn,
script/models/options.py:43-48).

  "nerfw"  NeRF-W / NeRF-Hist (fields/legacy.py NeRFW) with the N_vocab
           appearance and transient tables of nerfh.py:541-544,
           Embedding(N_vocab, 5) and Embedding(N_vocab, 2), looked up
           with the rounded histogram bins and flattened to hist_bin·5 /
           hist_bin·2 latents (run_network_NeRFH, nerfh.py:216-227).
           --ffmlp (NeRFH_FFMLP, a CUDA fused MLP in the reference) is the
           same field here.
  "nerf"   plain NeRF (fields/legacy.py PlainNeRF), --NeRFW False.
  "hash"   the instant-ngp hash-grid field (fields/hashgrid.py
           NeRFHTcnn), --tcnn / --sh_nff, with the same tables; raw xyz
           and directions (the hash encoding and SH replace the frequency
           embedding).

Unlike NeRFH-NFF these fields condition the fine tower on per-image
latents. ray_field_fns(hist) binds them: for one image's histogram
(bins,), or for a batch's (B, bins) with rays_per_image, every ray its
own image's latent, so that a training step renders all B·N rays in one
field pass. Gradients reach the tables through the lookup. No Pallas
kernel serves these fields in the JAX package, so they run plain
PyTorch: no exposure MLP (apply_exposure passes the rgb through) and no
FusionNet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.fields.hashgrid import NeRFHTcnn
from nefes_tpu_torch.fields.legacy import NeRFW, PlainNeRF
from nefes_tpu_torch.render.renderer import RenderConfig
from nefes_tpu_torch.utils.init import lecun_normal_

IDENTITY = EmbedConfig(num_freqs=0, max_freq_log2=0)


@dataclass(frozen=True)
class ZooConfig:
    kind: str = "nerfw"            # nerfw | nerf | hash
    depth: int = 8
    width: int = 128
    skips: tuple[int, ...] = (4,)
    xyz_embed: EmbedConfig = EmbedConfig(num_freqs=10)
    dir_embed: EmbedConfig = EmbedConfig(num_freqs=4)
    # the N_vocab tables (nerfh.py:541-544): N_a = 5, N_tau = 2
    n_vocab: int = 1000
    n_a: int = 5
    n_t: int = 2
    hist_bin: int = 10
    encode_hist: bool = True
    beta_min: float = 0.1
    # the hash grid (nerfh_tcnn.py, options.py:49, 58)
    bound: float = 25.0
    hash_level: int = 16
    tcnn_exact: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def has_latents(self) -> bool:
        return self.kind != "nerf" and self.encode_hist

    def render_config(self, **overrides) -> RenderConfig:
        if self.kind == "hash":
            # raw inputs: the hash encoding and SH are inside the field
            xyz, dirs = IDENTITY, IDENTITY
        else:
            xyz, dirs = self.xyz_embed, self.dir_embed
        overrides.setdefault("output_transient", self.kind != "nerf")
        return RenderConfig(xyz_embed=xyz, dir_embed=dirs, **overrides)


class Embed(nn.Module):
    """flax's nn.Embed: a (num, features) table looked up by index."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, features)
                                      * num ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class ZooFieldModel(nn.Module):
    """Coarse and fine field of a zoo kind and, with latents, the N_vocab
    tables embed_a / embed_t. Parameters are f32. Weights start random as
    the JAX package's (flax's initialisers): each Linear's weight
    truncated normal of variance 1 / fan_in (lecun_normal) and its bias
    zero, the hash tables uniform in [0, 2e-4), the N_vocab tables normal
    of variance 1 / n_vocab; drawn from `generator` when given, else from
    torch's global one. Load trained ones with
    weights.zoo_from_jax_variables.

    The zero biases matter to the hash field: its tables start near 0, so
    its ReLU sigma head starts near 0 wherever it is; with PyTorch's
    default (random) biases a tower's sigma can start below 0 everywhere,
    and its gradient is then 0 everywhere."""

    def __init__(self, cfg: ZooConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = c = cfg
        la = c.hist_bin * c.n_a if c.has_latents else 0
        lt = c.hist_bin * c.n_t if c.has_latents else 0
        if c.kind == "hash":
            kw = dict(bound=c.bound, hash_level=c.hash_level,
                      tcnn_exact=c.tcnn_exact, dtype=c.dtype)
            self.coarse = NeRFHTcnn(encode_transient=False, in_channels_a=0,
                                    in_channels_t=0, **kw)
            self.fine = NeRFHTcnn(encode_transient=True, in_channels_a=la,
                                  in_channels_t=lt, **kw)
        elif c.kind == "nerf":
            kw = dict(depth=c.depth, width=c.width, skips=c.skips,
                      in_channels_xyz=c.xyz_embed.out_dim,
                      in_channels_dir=c.dir_embed.out_dim, dtype=c.dtype)
            self.coarse, self.fine = PlainNeRF(**kw), PlainNeRF(**kw)
        elif c.kind == "nerfw":
            kw = dict(depth=c.depth, width=c.width, skips=c.skips,
                      in_channels_xyz=c.xyz_embed.out_dim,
                      in_channels_dir=c.dir_embed.out_dim,
                      in_channels_a=la, in_channels_t=lt,
                      beta_min=c.beta_min, dtype=c.dtype)
            self.coarse = NeRFW(typ="coarse", **kw)
            self.fine = NeRFW(typ="fine", **kw)
        else:
            raise ValueError(f"unknown zoo field kind {c.kind!r}")
        if c.has_latents:
            self.embed_a = Embed(c.n_vocab, c.n_a)
            self.embed_t = Embed(c.n_vocab, c.n_t)
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Draw every weight (on the CPU, from `generator` when given), so
        that a seed fixes the model whatever device it is built for."""
        for name, p in self.named_parameters():
            if ".encoder.level_" in name:
                p.copy_(torch.rand(p.shape, generator=generator) * 2e-4)
            elif name.endswith("embedding"):
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[0] ** -0.5)
        lecun_normal_(self, generator)

    # --- the latents (run_network_NeRFH, nerfh.py:216-227) ---

    def latents(self, hist: torch.Tensor):
        """hist (..., bins) rounded percent-density values -> (a (...,
        bins·n_a), t (..., bins·n_t)); (None, None) without tables. Each
        bin's value indexes the shared table (ts.long()), clipped to
        n_vocab - 1."""
        if not self.cfg.has_latents:
            return None, None
        ids = torch.clamp(torch.round(hist).long(), 0, self.cfg.n_vocab - 1)
        lead = hist.shape[:-1]
        return (self.embed_a(ids).reshape(*lead, -1),
                self.embed_t(ids).reshape(*lead, -1))

    # --- the renderer's field fns ---

    def _run(self, mod, xyz_emb, dir_emb, a_lat, t_lat, sigma_only,
             output_transient) -> dict:
        if self.cfg.kind == "nerf":
            return mod(xyz_emb, dir_emb, sigma_only=sigma_only)
        return mod(xyz_emb, dir_emb, a_lat, t_lat, sigma_only=sigma_only,
                   output_transient=output_transient)

    def ray_field_fns(self, hist: torch.Tensor | None = None,
                      rays_per_image: int | None = None):
        """(coarse_fn, fine_fn) with the fine field's latents bound: of one
        image's histogram (bins,), or of a batch's (B, bins) with
        rays_per_image N, the latents of image b on rays b·N to b·N + N - 1
        of the (B·N, S) samples the renderer gives. hist None: no
        latents (the fine field must then take none)."""
        a, t = (self.latents(hist) if hist is not None else (None, None))
        if rays_per_image is not None and a is not None:
            a, t = (x.repeat_interleave(rays_per_image, 0)[:, None]
                    for x in (a, t))

        def fine_fn(xyz_emb, dir_emb=None, sigma_only=False,
                    output_transient=True):
            return self._run(self.fine, xyz_emb, dir_emb, a, t,
                               sigma_only, output_transient)
        return self.coarse_fn, fine_fn

    def field_fns(self, cfg: RenderConfig, packed=None):
        """The latent-free (coarse_fn, fine_fn) under cfg: no kernel
        serves the zoo fields (the JAX package's render them outside
        Pallas too)."""
        if cfg.fused:
            raise ValueError(f"the {self.cfg.kind!r} zoo field runs no "
                             "kernel: render it with fused=False")
        return self.coarse_fn, self.fine_fn

    # latent-free fns (the sigma-only paths: TV, density probes)
    def coarse_fn(self, xyz_emb, dir_emb=None, sigma_only=False,
                  output_transient=False):
        return self._run(self.coarse, xyz_emb, dir_emb, None, None,
                           sigma_only, False)

    def fine_fn(self, xyz_emb, dir_emb=None, sigma_only=False,
                output_transient=True):
        a = t = None
        if self.cfg.has_latents:
            c = self.cfg
            a = xyz_emb.new_zeros(c.hist_bin * c.n_a)
            t = xyz_emb.new_zeros(c.hist_bin * c.n_t)
        return self._run(self.fine, xyz_emb, dir_emb, a, t, sigma_only,
                           output_transient)

    def apply_exposure(self, hist, rgb: torch.Tensor) -> torch.Tensor:
        """The zoo fields emit sigmoid rgb from the field head: no
        exposure MLP (an NFF component, nerfh_nff.py:511-522)."""
        return rgb

    def encoder_fns(self):
        """(coarse, fine) hash encodings of points in [0, 1]³ for
        embeddings_l1_loss (--l1normloss, reference losses.py:284-314);
        hash fields only."""
        if self.cfg.kind != "hash":
            raise ValueError("l1normloss regularises hash-grid tables; "
                             f"field kind is {self.cfg.kind!r}")
        dev = next(self.parameters()).device

        def make(enc):
            return lambda x01: enc(x01.to(dev))
        return make(self.coarse.encoder), make(self.fine.encoder)


def build_zoo_model(opts, device="cuda",
                    generator: torch.Generator | None = None
                    ) -> tuple[ZooConfig, ZooFieldModel]:
    """The CLI's dispatch for the fields other than NeRFH-NFF (the
    reference's flags, models/options.py:43-48, and create_nerf's
    branches); f32, as the JAX package's."""
    from nefes_tpu_torch.cli.train import embed_configs
    xyz, dirs = embed_configs(opts)
    common = dict(depth=opts.netdepth, width=opts.netwidth, xyz_embed=xyz,
                  dir_embed=dirs, n_vocab=opts.N_vocab,
                  hist_bin=opts.hist_bin, encode_hist=opts.encode_hist)
    if opts.tcnn or opts.sh_nff:
        cfg = ZooConfig(kind="hash", bound=opts.bound,
                        hash_level=opts.hash_level, **common)
    elif not opts.NeRFW:
        cfg = ZooConfig(kind="nerf", **common)
    else:   # --ffmlp or --nerfh_nff False: the legacy NeRF-W tower
        cfg = ZooConfig(kind="nerfw", **common)
    return cfg, ZooFieldModel(cfg, device=device, generator=generator)
