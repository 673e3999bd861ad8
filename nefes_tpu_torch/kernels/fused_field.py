"""Fused NeRFH-NFF field: the MLP tower and its heads, as hand-written
Hopper kernels (csrc/fused_field.cu) with a plain PyTorch version of each,
on pre-embedded inputs (K1, K2) or on raw points and directions (K5, K6).

  K1 field_fwd_pre  replaces nefes_tpu/kernels/fused_field.py:_run_fwd_pre
                    (_fwd_kernel_pre, _tower_tile)
  K2 field_bwd_pre  replaces _run_bwd_pre (_bwd_kernel_pre, _mlp_backward
                    with pre=True): it recomputes the tower and returns the
                    embedding cotangents and, with need_dw, the weights'
  K5 field_fwd      replaces _run_fwd (_fwd_kernel, _embed_block): the
                    frequency embedding computed in the kernel, heads in f32
  K6 field_bwd      replaces _run_bwd (_bwd_kernel, _mlp_backward with
                    pre=False): d_pts, d_dirs in f32 and, with need_dw, the
                    weights' gradients

K1/K5 in every mode (sigma, full and transient) run the render kernels'
warp path (csrc/render_bwd.cuh) as a persistent grid of fwd_blocks()
blocks over block tiles of BLOCK_TILE samples; K2/K6 in sigma and full
mode run it too, on a persistent grid that the C entry point sizes to the
card (one block an SM), each warp recomputing its rows' forward and then
running their backward; K2/K6 in transient mode run csrc/tower.cuh's
tiles of TILE_ROWS. K2/K6 with need_dw run over chunks of rows (dw_plan,
whole TILE_ROWS tiles, so a chunk may end mid block tile): each launch
writes the chunk's dW operands (every layer's input and output
cotangent, row-major) and per-tile bias sums, and the dW kernel
(field_dw, csrc/field_dw.cuh) contracts them over the chunk's rows into
row-slice partials that field_dw_reduce sums.

All four follow _tower_tile's rounding points: hidden layers accumulate in
f32 and round to the pack dtype, then take the bias and the ReLU in the
pack dtype; the heads accumulate in f32. K1/K2 write heads and embedding
cotangents in the pack dtype, K5/K6 (as the TPU kernels) take and give f32.
K5/K6 embed in f32 (exact phases x·2^k, full-precision sin/cos, rounded to
the pack dtype) in the reference channel order, so all kernels read the one
PackedField layout. Modes: "sigma" (coarse pass at test time), "full"
(sigma + rgb + features) and "transient" (full + the NeRF-W transient
heads of the fine tower, at train time). With need_dw (training) the
backward also gives each packed weight's gradient, f32 like the TPU
kernel's, and the autograd Function hands it, cast to the pack dtype as
JAX does, to the blobs, which pack_params builds with autograd from the
nn.Linear parameters. Each wrapper runs its kernel for a CUDA tensor and
its plain version for a CPU tensor; it counts kernel launches in
``<wrapper>.launches`` (K1/K5 also ``.transient_launches``, K2/K6
``.dw_launches`` for those variants; K2/K6 with need_dw launch once a
chunk, and field_dw once a chunk).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from nefes_tpu_torch.fields.embedder import EmbedConfig, embed
from nefes_tpu_torch.kernels import build

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# modes of the kernels (csrc/tower.cuh Mode); True / False read as FULL /
# SIGMA
SIGMA, FULL, TRANSIENT = 0, 1, 2
TILE_ROWS = 64      # samples per tower tile (csrc/tower.cuh TR)
# the backward with dW: the most bytes of one chunk's dW operands and bias
# sums, and the dW kernel's blocks an SM the row slices aim at
DW_SCRATCH_BYTES = 1 << 30
DW_BLOCKS_PER_SM = 4
BLOCK_TILE = 128    # samples per block tile of the warp path, K1/K5 and
#                     K2/K6 in sigma and full mode (csrc/render_bwd.cuh BT)


@dataclass(frozen=True)
class FieldSpec:
    """Static shape description of one NeRFH-NFF tower (the JAX package's
    FieldSpec without its TPU tile size)."""

    depth: int = 8
    width: int = 128
    skips: tuple[int, ...] = (4,)
    n_freqs_xyz: int = 10
    n_freqs_dir: int = 4
    feature_dim: int = 128
    transient: bool = False          # fine tower has transient heads
    dtype: str = "bfloat16"          # pack dtype ("float32" for parity tests)

    @property
    def emb_xyz(self) -> int:
        return 3 + 6 * self.n_freqs_xyz

    @property
    def emb_dir(self) -> int:
        return 3 + 6 * self.n_freqs_dir

    @property
    def half(self) -> int:
        return self.width // 2

    @property
    def rgbfeat(self) -> int:
        return 3 + self.feature_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def skipmask(self) -> int:
        return sum(1 << i for i in self.skips if 0 < i < self.depth)

    @classmethod
    def from_model(cls, model_cfg, typ: str, **kw) -> "FieldSpec":
        """Build from a train.ModelConfig."""
        return cls(depth=model_cfg.depth, width=model_cfg.width,
                   skips=tuple(model_cfg.skips),
                   n_freqs_xyz=model_cfg.xyz_embed.num_freqs,
                   n_freqs_dir=model_cfg.dir_embed.num_freqs,
                   feature_dim=model_cfg.feature_dim,
                   transient=(typ == "fine"), **kw)


def weight_names(spec: FieldSpec) -> list[str]:
    """Packed array order, as in the JAX package."""
    names = []
    for i in range(spec.depth):
        if i == 0:
            names += [f"l{i}_we"]
        elif i in spec.skips:
            names += [f"l{i}_we", f"l{i}_wh"]
        else:
            names += [f"l{i}_wh"]
        names += [f"l{i}_b"]
    names += ["sig_w", "sig_b", "fin_w", "fin_b",
              "dir_wh", "dir_wd", "dir_b", "rgb_w", "rgb_b"]
    if spec.transient:
        names += ["t1_wh", "t1_wd", "t1_b", "t2_w", "t2_b", "t3_w", "t3_b",
                  "ts_w", "ts_b", "tr_w", "tr_b", "tb_w", "tb_b"]
    return names


def matrix_names(spec: FieldSpec) -> list[str]:
    return [n for n in weight_names(spec) if not n.endswith("_b")]


def bias_names(spec: FieldSpec) -> list[str]:
    return [n for n in weight_names(spec) if n.endswith("_b")]


@dataclass(frozen=True)
class PackedField:
    """Tower weights as the kernels read them.

    weights: name -> tensor in weight_names order; matrices (in, out) in
    the pack dtype, biases (out,) f32. w / wt: every matrix, in
    weight_names order (the transient ones, when the tower has them,
    after every static one), flattened into one blob, (in, out) and
    transposed (out, in) at the same offsets. b: the biases in one f32
    blob. Built with autograd from the tower's parameters, so a gradient
    of w and b reaches them."""

    spec: FieldSpec
    weights: dict
    w: torch.Tensor
    wt: torch.Tensor
    b: torch.Tensor


def pack_params(tower, spec: FieldSpec) -> PackedField:
    """A torch NeRFHNFF -> PackedField, differentiable in the tower's
    parameters (the JAX package's pack_params is too): pack once per
    training step; a frozen-field refinement packs once, under
    torch.no_grad(). Linear weights (out, in) become (in, out) matrices;
    the skip, dir and first transient layers (one Linear over a concat)
    are split into their row blocks. The rows keep the reference embedding
    order, the only layout the kernels read (the raw-input kernels embed in
    that order; the TPU package permutes rows for its raw kernels)."""
    dt = spec.torch_dtype
    E, W = spec.emb_xyz, spec.width

    def k(name):
        return getattr(tower, name).weight.t()

    def b(name):
        return getattr(tower, name).bias.float()

    out = {}
    for i in range(spec.depth):
        kern = k(f"xyz_encoding_{i + 1}")
        if i == 0:
            out[f"l{i}_we"] = kern
        elif i in spec.skips:
            out[f"l{i}_we"], out[f"l{i}_wh"] = kern[:E], kern[E:]
        else:
            out[f"l{i}_wh"] = kern
        out[f"l{i}_b"] = b(f"xyz_encoding_{i + 1}")
    out["sig_w"], out["sig_b"] = k("static_sigma"), b("static_sigma")
    out["fin_w"] = k("xyz_encoding_final")
    out["fin_b"] = b("xyz_encoding_final")
    dk = k("dir_encoding")
    out["dir_wh"], out["dir_wd"] = dk[:W], dk[W:]
    out["dir_b"] = b("dir_encoding")
    out["rgb_w"], out["rgb_b"] = k("static_rgb"), b("static_rgb")
    if spec.transient:
        tk = k("transient_encoding_1")
        out["t1_wh"], out["t1_wd"] = tk[:W], tk[W:]
        out["t1_b"] = b("transient_encoding_1")
        for n, m in (("t2", "transient_encoding_2"),
                     ("t3", "transient_encoding_3"),
                     ("ts", "transient_sigma"), ("tr", "transient_rgb"),
                     ("tb", "transient_beta")):
            out[f"{n}_w"], out[f"{n}_b"] = k(m), b(m)
    weights = {n: (v if n.endswith("_b") else v.to(dt))
               for n, v in out.items()}
    mats = [weights[n] for n in matrix_names(spec)]
    return PackedField(
        spec=spec, weights=weights,
        w=torch.cat([m.reshape(-1) for m in mats]),
        wt=torch.cat([m.t().reshape(-1) for m in mats]),
        b=torch.cat([weights[n] for n in bias_names(spec)]))


# --------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, written with torch ops)
# --------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor, cd=None) -> torch.Tensor:
    """a @ w with f32 accumulation, rounded to cd when given."""
    out = a.float() @ w.float()
    return out if cd is None else out.to(cd)


def _mm_t(g: torch.Tensor, w: torch.Tensor, cd=None) -> torch.Tensor:
    """g @ w^T with f32 accumulation, rounded to cd when given."""
    out = g.float() @ w.float().t()
    return out if cd is None else out.to(cd)


def tower_plain(p: PackedField, mode: int, emb: torch.Tensor,
                embd: torch.Tensor | None):
    """_tower_tile on pre-embedded inputs in the pack dtype: returns
    (zs (N,) f32 sigma pre-activation, rgbfeat (N, 3+F) f32 | None,
    activations for the backward; in TRANSIENT mode acts["tz"] holds the
    transient heads' pre-activations (N, 5) f32)."""
    spec, w = p.spec, p.weights
    cd = spec.torch_dtype
    acts = {"emb": emb}
    h = emb
    for i in range(spec.depth):
        z = _mm(h if i else emb, w[f"l{i}_wh" if i else f"l{i}_we"], cd)
        if i and i in spec.skips:
            z = z + _mm(emb, w[f"l{i}_we"], cd)
        h = torch.relu(z + w[f"l{i}_b"].to(cd))
        acts[f"h{i}"] = h
    zs = (_mm(h, w["sig_w"]) + w["sig_b"])[:, 0]
    acts["zs"] = zs
    if mode == SIGMA:
        return zs, None, acts
    final = _mm(h, w["fin_w"], cd) + w["fin_b"].to(cd)
    zd = (_mm(final, w["dir_wh"], cd) + _mm(embd, w["dir_wd"], cd)
          + w["dir_b"].to(cd))
    de = torch.relu(zd)
    acts.update(final=final, de=de, embd=embd)
    if mode == TRANSIENT:
        t = torch.relu(_mm(final, w["t1_wh"], cd) + _mm(embd, w["t1_wd"], cd)
                       + w["t1_b"].to(cd))
        acts["t1"] = t
        for n in ("t2", "t3"):
            t = torch.relu(_mm(t, w[f"{n}_w"], cd) + w[f"{n}_b"].to(cd))
            acts[n] = t
        acts["tz"] = torch.cat([_mm(t, w[f"{n}_w"]) + w[f"{n}_b"]
                                for n in ("ts", "tr", "tb")], dim=1)
    return zs, _mm(de, w["rgb_w"]) + w["rgb_b"], acts


def tower_backward_plain(p: PackedField, mode: int, acts: dict,
                         g_sigma: torch.Tensor,
                         g_rgbfeat: torch.Tensor | None,
                         g_trans: torch.Tensor | None = None,
                         need_dw: bool = False):
    """_mlp_backward with pre=True. g_sigma (N,) is the cotangent of
    softplus(zs), g_rgbfeat (N, 3+F) that of the rgb/feature head, g_trans
    (N, 5) that of the transient heads. Returns (d_emb (N, E) f32, d_embd
    (N, Ed) f32 | None, dw): with need_dw, dw is every packed weight's
    gradient, f32, in the blob order (the matrices, flattened, then the
    biases), else None. A weight's gradient is act^T · g with g rounded to
    the pack dtype, a bias's the f32 sum of g (_mlp_backward's dmat)."""
    spec, w = p.spec, p.weights
    cd = spec.torch_dtype
    dws = {}

    def dw_only(g, act, wname, bname=None):
        if need_dw:
            dws[wname] = _mm(act.t(), g.to(cd))
            if bname:
                dws[bname] = g.float().sum(0)

    def dmat(g, act, wname, bname):
        dw_only(g, act, wname, bname)
        return _mm_t(g.to(cd), w[wname], cd)

    h_last = acts[f"h{spec.depth - 1}"]
    dzs = g_sigma.float() * torch.sigmoid(acts["zs"])        # softplus'
    dh = dmat(dzs[:, None], h_last, "sig_w", "sig_b")
    d_embd = None
    if mode != SIGMA:
        dde = dmat(g_rgbfeat.float(), acts["de"], "rgb_w", "rgb_b")
        dzd = dde * (acts["de"] > 0)
        d_final = dmat(dzd, acts["final"], "dir_wh", "dir_b")
        dw_only(dzd, acts["embd"], "dir_wd")
        d_embd = _mm_t(dzd, w["dir_wd"])
        if mode == TRANSIENT:
            g, tz = g_trans.float(), acts["tz"]
            s = torch.sigmoid(tz)
            dz5 = torch.cat([g[:, :1] * s[:, :1],
                             g[:, 1:4] * s[:, 1:4] * (1.0 - s[:, 1:4]),
                             g[:, 4:] * s[:, 4:]], dim=1)
            t3 = acts["t3"]
            dt = (dmat(dz5[:, :1], t3, "ts_w", "ts_b")
                  + dmat(dz5[:, 1:4], t3, "tr_w", "tr_b")
                  + dmat(dz5[:, 4:], t3, "tb_w", "tb_b"))
            for n, prev in (("t3", "t2"), ("t2", "t1")):
                dt = dmat(dt * (acts[n] > 0), acts[prev], f"{n}_w", f"{n}_b")
            dzt1 = dt * (acts["t1"] > 0)
            d_final = d_final + dmat(dzt1, acts["final"], "t1_wh", "t1_b")
            dw_only(dzt1, acts["embd"], "t1_wd")
            d_embd = d_embd + _mm_t(dzt1, w["t1_wd"])
        dh = dh + dmat(d_final, h_last, "fin_w", "fin_b")
    d_emb = torch.zeros(acts["emb"].shape, dtype=torch.float32,
                        device=dh.device)
    for i in range(spec.depth - 1, -1, -1):
        dz = dh * (acts[f"h{i}"] > 0)
        if i == 0:
            dw_only(dz, acts["emb"], "l0_we", "l0_b")
            d_emb = d_emb + _mm_t(dz, w["l0_we"])
        else:
            dh = dmat(dz, acts[f"h{i - 1}"], f"l{i}_wh", f"l{i}_b")
            if i in spec.skips:
                dw_only(dz, acts["emb"], f"l{i}_we")
                d_emb = d_emb + _mm_t(dz, w[f"l{i}_we"])
    if not need_dw:
        return d_emb, d_embd, None
    flat = [dws[n].reshape(-1) if n in dws
            else torch.zeros(w[n].numel(), device=dh.device)
            for n in matrix_names(spec) + bias_names(spec)]
    return d_emb, d_embd, torch.cat(flat)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _transient_heads(tz: torch.Tensor) -> torch.Tensor:
    """[softplus, sigmoid x3, softplus] of the (N, 5) pre-activations."""
    return torch.cat([_softplus(tz[:, :1]), torch.sigmoid(tz[:, 1:4]),
                      _softplus(tz[:, 4:])], dim=1)


def _heads_plain(p: PackedField, mode: int, emb, embd, hd):
    """(sigma (N,), rgb (N, 3) | None, feat (N, F) | None, transient (N, 5)
    | None), all in hd."""
    zs, rf, acts = tower_plain(p, mode, emb, embd)
    sigma = _softplus(zs).to(hd)
    if mode == SIGMA:
        return sigma, None, None, None
    trans = (_transient_heads(acts["tz"]).to(hd) if mode == TRANSIENT
             else None)
    return sigma, rf[:, :3].to(hd), rf[:, 3:].to(hd), trans


def _cotangents(mode: int, g_rgb, g_feat, g_trans):
    g_rf = torch.cat([g_rgb, g_feat], dim=1) if mode != SIGMA else None
    return g_rf, (g_trans if mode == TRANSIENT else None)


def field_fwd_pre_plain(p: PackedField, mode: int, emb: torch.Tensor,
                        embd: torch.Tensor | None):
    """K1's function: (sigma (N,), rgb (N, 3) | None, feat (N, F) | None,
    transient (N, 5) | None), all in the pack dtype."""
    return _heads_plain(p, mode, emb, embd, p.spec.torch_dtype)


def field_bwd_pre_plain(p: PackedField, mode: int, emb, embd, g_sigma,
                        g_rgb, g_feat, g_trans=None, need_dw=False):
    """K2's function: recompute the tower, backprop the head cotangents
    (pack dtype) to (d_emb, d_embd | None) in the pack dtype, and with
    need_dw the weights' f32 gradients in blob order (else None)."""
    cd = p.spec.torch_dtype
    _, _, acts = tower_plain(p, mode, emb, embd)
    d_emb, d_embd, dw = tower_backward_plain(
        p, mode, acts, g_sigma, *_cotangents(mode, g_rgb, g_feat, g_trans),
        need_dw=need_dw)
    return (d_emb.to(cd), (d_embd.to(cd) if mode != SIGMA else None), dw)


def embed_plain(x: torch.Tensor, n_freqs: int, cd) -> torch.Tensor:
    """_embed_block: x (N, 3) f32 -> (N, 3 + 6·n_freqs) in the reference
    order, f32 phases and sin/cos rounded to cd."""
    return embed(x.float(), EmbedConfig(num_freqs=n_freqs)).to(cd)


def embed_backward_plain(d_e: torch.Tensor, x: torch.Tensor,
                         n_freqs: int) -> torch.Tensor:
    """The d_embed step of _mlp_backward: the embedding cotangent d_e
    (N, 3 + 6·n_freqs) f32 back to x (N, 3), in f32, the phases recomputed
    from x."""
    out = d_e[:, :3]
    for k in range(n_freqs):
        ph = x * 2.0 ** k
        d_sin, d_cos = d_e[:, 3 + 6 * k:6 + 6 * k], d_e[:, 6 + 6 * k:9 + 6 * k]
        out = out + (d_sin * torch.cos(ph) - d_cos * torch.sin(ph)) * 2.0 ** k
    return out


def _embed_raw(p: PackedField, full, pts, dirs):
    spec, cd = p.spec, p.spec.torch_dtype
    emb = embed_plain(pts, spec.n_freqs_xyz, cd)
    return emb, (embed_plain(dirs, spec.n_freqs_dir, cd) if full else None)


def field_fwd_plain(p: PackedField, mode: int, pts: torch.Tensor,
                    dirs: torch.Tensor | None):
    """K5's function: pts, dirs (N, 3) f32 -> (sigma (N,), rgb (N, 3) |
    None, feat (N, F) | None, transient (N, 5) | None), all f32."""
    return _heads_plain(p, mode, *_embed_raw(p, mode, pts, dirs),
                        torch.float32)


def field_bwd_plain(p: PackedField, mode: int, pts, dirs, g_sigma, g_rgb,
                    g_feat, g_trans=None, need_dw=False):
    """K6's function: recompute the tower, backprop the f32 head
    cotangents to (d_pts (N, 3), d_dirs (N, 3) | None) in f32, and with
    need_dw the weights' f32 gradients in blob order (else None)."""
    spec = p.spec
    _, _, acts = tower_plain(p, mode, *_embed_raw(p, mode, pts, dirs))
    d_emb, d_embd, dw = tower_backward_plain(
        p, mode, acts, g_sigma, *_cotangents(mode, g_rgb, g_feat, g_trans),
        need_dw=need_dw)
    d_pts = embed_backward_plain(d_emb, pts, spec.n_freqs_xyz)
    if mode == SIGMA:
        return d_pts, None, dw
    return d_pts, embed_backward_plain(d_embd, dirs, spec.n_freqs_dir), dw


# the dW operand slots of a chunk, in their order (csrc/tower.cuh DwSlot):
# the embeddings, the dir layer's output and t1..t3 (A side), the sigma,
# final, dir, rgb/feature, transient layers' and heads' cotangents (G
# side), the hidden layers h_0..h_{depth-1} and final, and the hidden
# layers' cotangents
(_A_EMB, _A_EMBD, _A_DE, _A_T1, _A_T2, _A_T3, _G_SIG, _G_FIN, _G_DIR,
 _G_RGB, _G_T1, _G_T2, _G_T3, _G_TS, _G_TR, _G_TB) = range(16)
_MAX_DEPTH = 16
_A_H = 16
_G_DZ = _A_H + _MAX_DEPTH + 1
_N_SLOTS = _G_DZ + _MAX_DEPTH


def _slot_cols(spec: FieldSpec, mode: int) -> list[int]:
    """Columns of each slot in `mode` (0: not used)."""
    W, H, D = spec.width, spec.half, spec.depth
    cols = [0] * _N_SLOTS
    cols[_A_EMB], cols[_G_SIG] = spec.emb_xyz, 1
    for i in range(D):
        cols[_A_H + i] = cols[_G_DZ + i] = W
    if mode != SIGMA:
        cols[_A_EMBD], cols[_G_RGB] = spec.emb_dir, spec.rgbfeat
        cols[_A_DE] = cols[_G_DIR] = H
        cols[_G_FIN] = cols[_A_H + D] = W
    if mode == TRANSIENT:
        for k in (_A_T1, _A_T2, _A_T3, _G_T1, _G_T2, _G_T3):
            cols[k] = H
        cols[_G_TS], cols[_G_TR], cols[_G_TB] = 1, 3, 1
    return cols


def dw_operands(spec: FieldSpec, mode: int, ops: torch.Tensor,
                rows: int) -> list:
    """The slots of a chunk of `rows` rows in the operand buffer ops: one
    (rows, columns) view a slot (None where `mode` has none), each slot a
    row-major (rows, ld) block, ld the columns rounded up to 8."""
    views, off = [], 0
    for c in _slot_cols(spec, mode):
        ld = -(-c // 8) * 8
        views.append(ops[off:off + rows * ld].view(rows, ld)[:, :c] if c
                     else None)
        off += rows * ld
    return views


def dw_products(spec: FieldSpec, mode: int) -> list:
    """(A slot, G slot, weight name) of every dW product of `mode`, in the
    dW kernel's order (csrc/field_dw.cuh dw_prod)."""
    D = spec.depth
    out = [(_A_EMB, _G_DZ, "l0_we")]
    for i in range(1, D):
        out.append((_A_H + i - 1, _G_DZ + i, f"l{i}_wh"))
        if i in spec.skips:
            out.append((_A_EMB, _G_DZ + i, f"l{i}_we"))
    out.append((_A_H + D - 1, _G_SIG, "sig_w"))
    if mode != SIGMA:
        out += [(_A_H + D - 1, _G_FIN, "fin_w"), (_A_H + D, _G_DIR, "dir_wh"),
                (_A_EMBD, _G_DIR, "dir_wd"), (_A_DE, _G_RGB, "rgb_w")]
    if mode == TRANSIENT:
        out += [(_A_H + D, _G_T1, "t1_wh"), (_A_EMBD, _G_T1, "t1_wd"),
                (_A_T1, _G_T2, "t2_w"), (_A_T2, _G_T3, "t3_w"),
                (_A_T3, _G_TS, "ts_w"), (_A_T3, _G_TR, "tr_w"),
                (_A_T3, _G_TB, "tb_w")]
    return out


def dw_biases(spec: FieldSpec, mode: int) -> tuple:
    """The biases of `mode` as the dW kernel sums them: (G slot, bias name)
    of those whose gradient is the column sum of a rounded G operand, and
    the names of the head biases (unrounded cotangents) whose per-tile
    sums the backward leaves."""
    from_g = [(_G_DZ + i, f"l{i}_b") for i in range(spec.depth)]
    heads = ["sig_b"]
    if mode != SIGMA:
        from_g += [(_G_FIN, "fin_b"), (_G_DIR, "dir_b")]
        heads.append("rgb_b")
    if mode == TRANSIENT:
        from_g += [(_G_T1, "t1_b"), (_G_T2, "t2_b"), (_G_T3, "t3_b")]
        heads += ["ts_b", "tr_b", "tb_b"]
    return from_g, heads


def field_dw_plain(p: PackedField, mode: int, ops: torch.Tensor,
                   tile_b: torch.Tensor, rows: int) -> torch.Tensor:
    """The dW kernel's function on one chunk of `rows` rows: each product's
    A^T @ G in f32 over the operand buffer ops (dw_operands), each bias
    the f32 column sum of its G, a head bias the sum of the chunk's
    per-tile sums tile_b (tiles, nb); the weights' f32 gradients in blob
    order (the matrices, then the biases)."""
    spec = p.spec
    views = dw_operands(spec, mode, ops, rows)
    offs, o = {}, 0
    for name in matrix_names(spec) + bias_names(spec):
        offs[name] = o
        o += p.weights[name].numel()
    nw = p.w.numel()
    out = torch.zeros(o, device=ops.device)

    def put(name, v):
        out[offs[name]:offs[name] + v.numel()] = v.reshape(-1)

    for a, g, name in dw_products(spec, mode):
        put(name, views[a].float().t() @ views[g].float())
    from_g, heads = dw_biases(spec, mode)
    for g, name in from_g:
        put(name, views[g].float().sum(0))
    tiles = tile_b[:-(-rows // TILE_ROWS)]
    for name in heads:
        b0 = offs[name] - nw
        put(name, tiles[:, b0:b0 + p.weights[name].numel()].sum(0))
    return out


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_packed(p: PackedField, device: torch.device) -> None:
    spec = p.spec
    if spec.width % 32 or spec.depth > 16:
        raise ValueError("the kernels take width % 32 == 0, depth <= 16")
    cd = spec.torch_dtype
    check(p.w, "w", p.w.shape, cd, device)
    check(p.wt, "wt", p.w.shape, cd, device)
    check(p.b, "b", p.b.shape, torch.float32, device)


def _check_mode(p: PackedField, mode: int) -> int:
    mode = int(mode)
    if mode not in (SIGMA, FULL, TRANSIENT):
        raise ValueError(f"mode {mode}")
    if mode == TRANSIENT and not p.spec.transient:
        raise ValueError("transient mode needs a tower packed with its "
                         "transient heads (the fine tower)")
    return mode


def dims(spec: FieldSpec) -> tuple:
    return (spec.depth, spec.width, spec.skipmask, spec.emb_xyz,
            spec.emb_dir, spec.feature_dim)


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _fwd_outputs(spec: FieldSpec, mode: int, n: int, hd, dev):
    """Empty (sigma, rgb, feat, transient) for the heads of `mode`."""
    def e(*shape):
        return torch.empty(shape, dtype=hd, device=dev)
    return (e(n), e(n, 3) if mode else None,
            e(n, spec.feature_dim) if mode else None,
            e(n, 5) if mode == TRANSIENT else None)


def _check_cotangents(spec, mode, n, hd, dev, g_sigma, g_rgb, g_feat,
                      g_trans):
    check(g_sigma, "g_sigma", (n,), hd, dev)
    if mode != SIGMA:
        check(g_rgb, "g_rgb", (n, 3), hd, dev)
        check(g_feat, "g_feat", (n, spec.feature_dim), hd, dev)
    if mode == TRANSIENT:
        check(g_trans, "g_trans", (n, 5), hd, dev)


def dw_plan(lib, p: PackedField, mode: int, n: int, sms: int) -> tuple:
    """(chunk, slices) of a backward with dW over n rows on a card of `sms`
    SMs: chunks of equal whole tiles whose operands and bias sums take at
    most DW_SCRATCH_BYTES, and row slices enough for DW_BLOCKS_PER_SM
    blocks of the dW kernel an SM (at most one a tile). Fixed by the
    shapes, so two calls sum in the same order."""
    spec = p.spec
    nb = p.b.numel()
    elem = torch.empty((), dtype=spec.torch_dtype).element_size()
    tile_bytes = (lib.nefes_field_dw_row_elems(mode, *dims(spec)) * elem
                  * TILE_ROWS + nb * 4)
    most = max(1, DW_SCRATCH_BYTES // tile_bytes)
    tiles = max(1, -(-n // TILE_ROWS))
    per = -(-tiles // -(-tiles // most))
    jobs = lib.nefes_field_dw_jobs(mode, *dims(spec))
    return per * TILE_ROWS, max(1, min(per, -(-DW_BLOCKS_PER_SM * sms
                                             // jobs)))


def bwd_dw(lib, bwd, dw, p: PackedField, mode: int, n: int, chunk: int,
           slices: int, dev) -> torch.Tensor:
    """The backward with dW over n rows in chunks of `chunk` rows (a
    multiple of TILE_ROWS): bwd(row0, rows, ops, tile_b) launches the
    backward over one chunk, which writes its dW operands to ops and its
    tiles' head bias sums to tile_b; dw(ops, tile_b, rows, part) adds the
    chunk's gradients into part. Returns part, (slices, nw + nb) f32."""
    spec = p.spec
    nb = p.b.numel()
    ops = torch.empty(chunk * lib.nefes_field_dw_row_elems(mode, *dims(spec)),
                      dtype=spec.torch_dtype, device=dev)
    tile_b = torch.zeros((chunk // TILE_ROWS, nb), device=dev)
    part = torch.zeros((slices, p.w.numel() + nb), device=dev)
    for row0 in range(0, n, chunk):
        rows = min(chunk, n - row0)
        bwd(row0, rows, ops, tile_b)
        dw(ops, tile_b, rows, part)
    return part


def dw_launch(lib, p: PackedField, mode: int, ops, tile_b, rows: int,
              part, stream) -> int:
    """Launch the dW kernel of `lib` on one chunk (no checks, no count);
    its error code."""
    return lib.nefes_field_dw(_DTYPE_CODE[p.spec.torch_dtype], mode, rows,
                              part.shape[0], *dims(p.spec), ops.data_ptr(),
                              tile_b.data_ptr(), p.w.numel(), p.b.numel(),
                              part.data_ptr(), stream)


def _dw_reduce(lib, part: torch.Tensor) -> torch.Tensor:
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    err = lib.nefes_field_dw_reduce(part.shape[0], part.shape[1],
                                    part.data_ptr(), out.data_ptr(),
                                    _stream())
    raise_on(err, "field_dw_reduce")
    return out


@functools.lru_cache(maxsize=None)
def _resident_blocks(lib, dev: torch.device, code: int, mode: int, raw: bool,
                     dim: tuple) -> int:
    """Blocks of the K1/K5 forward in `mode` that the card holds at once:
    its SMs times the blocks one SM holds (occupancy calculator)."""
    per_sm = lib.nefes_field_blocks_per_sm(code, mode, int(raw), *dim)
    if per_sm <= 0:
        raise RuntimeError(f"field forward mode {mode}: occupancy query "
                           f"failed ({per_sm})")
    return per_sm * torch.cuda.get_device_properties(dev).multi_processor_count


def fwd_blocks(lib, p: PackedField, mode: int, raw: bool, n: int,
               dev: torch.device) -> int:
    """The persistent grid of the K1/K5 forward: as many blocks as the
    card holds at once, at most one per block tile of BLOCK_TILE
    samples."""
    return min(-(-n // BLOCK_TILE),
               _resident_blocks(lib, dev, _DTYPE_CODE[p.spec.torch_dtype],
                                mode, raw, dims(p.spec)))


def _launch_fwd(wrapper, p, mode, x, dirs, hd, raw):
    """Allocate, launch K1 (or, raw, K5), count."""
    spec, dev, n = p.spec, x.device, x.shape[0]
    lib = build.library("fused_field")
    fn = lib.nefes_field_fwd_raw if raw else lib.nefes_field_fwd_pre
    outs = _fwd_outputs(spec, mode, n, hd, dev)
    err = fn(_DTYPE_CODE[spec.torch_dtype], mode, n, x.data_ptr(), _ptr(dirs),
             p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(), *dims(spec),
             *[_ptr(o) for o in outs], fwd_blocks(lib, p, mode, raw, n, dev),
             _stream())
    wrapper.launches += 1
    if mode == TRANSIENT:
        wrapper.transient_launches += 1
    raise_on(err, wrapper.__name__)
    return outs


def _launch_bwd(wrapper, fn, p, mode, x, dirs, g, dx_w, ddirs_w, dx_dtype,
                need_dw):
    """Allocate, launch K2/K6 (with need_dw once a chunk, each followed by
    the dW kernel, then the reduction), count."""
    spec, dev, n = p.spec, x.device, x.shape[0]
    lib = build.library("fused_field")
    dx = torch.empty((n, dx_w), dtype=dx_dtype, device=dev)
    ddirs = (torch.empty((n, ddirs_w), dtype=dx_dtype, device=dev)
             if mode != SIGMA else None)

    def bwd(row0, rows, ops, tile_b):
        err = fn(_DTYPE_CODE[spec.torch_dtype], mode, n, x.data_ptr(),
                 _ptr(dirs), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
                 *dims(spec), *[_ptr(v) for v in g], dx.data_ptr(),
                 _ptr(ddirs), row0, rows, p.b.numel(), _ptr(ops),
                 _ptr(tile_b), _stream())
        wrapper.launches += 1
        if mode == TRANSIENT:
            wrapper.transient_launches += 1
        if ops is not None:
            wrapper.dw_launches += 1
        raise_on(err, wrapper.__name__)

    if not need_dw:
        bwd(0, n, None, None)
        return dx, ddirs, None
    chunk, slices = dw_plan(
        lib, p, mode, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = bwd_dw(lib, bwd,
                  lambda ops, tile_b, rows, part: field_dw(p, mode, ops,
                                                           tile_b, rows, part),
                  p, mode, n, chunk, slices, dev)
    return dx, ddirs, _dw_reduce(lib, part)


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (run the kernel), False for a CPU one (run
    the plain version); other devices have no kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def field_fwd_pre(p: PackedField, mode: int, emb: torch.Tensor,
                  embd: torch.Tensor | None):
    """K1: the tower forward. emb (N, E), embd (N, Ed) in the pack dtype;
    returns (sigma, rgb, feat, transient (N, 5)), those of `mode`, in the
    pack dtype. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    mode = _check_mode(p, mode)
    if not _kernel_device(emb):
        return field_fwd_pre_plain(p, mode, emb, embd)
    spec, dev, cd = p.spec, emb.device, p.spec.torch_dtype
    n = emb.shape[0]
    check_packed(p, dev)
    check(emb, "emb", (n, spec.emb_xyz), cd, dev)
    if mode != SIGMA:
        check(embd, "embd", (n, spec.emb_dir), cd, dev)
    return _launch_fwd(field_fwd_pre, p, mode, emb, embd, cd, False)


def field_bwd_pre(p: PackedField, mode: int, emb, embd, g_sigma, g_rgb,
                  g_feat, g_trans=None, need_dw=False):
    """K2: recompute the tower and backprop the head cotangents (pack
    dtype) to (d_emb, d_embd | None) in the pack dtype and, with need_dw,
    the weights' f32 gradients in blob order (else None)."""
    mode = _check_mode(p, mode)
    if not _kernel_device(emb):
        return field_bwd_pre_plain(p, mode, emb, embd, g_sigma, g_rgb,
                                   g_feat, g_trans, need_dw)
    spec, dev, cd = p.spec, emb.device, p.spec.torch_dtype
    n = emb.shape[0]
    check_packed(p, dev)
    check(emb, "emb", (n, spec.emb_xyz), cd, dev)
    if mode != SIGMA:
        check(embd, "embd", (n, spec.emb_dir), cd, dev)
    g = (g_sigma, g_rgb, g_feat, g_trans)
    _check_cotangents(spec, mode, n, cd, dev, *g)
    lib = build.library("fused_field")
    return _launch_bwd(field_bwd_pre, lib.nefes_field_bwd_pre, p, mode, emb,
                       embd, g, spec.emb_xyz, spec.emb_dir, cd, need_dw)


def field_fwd(p: PackedField, mode: int, pts: torch.Tensor,
              dirs: torch.Tensor | None):
    """K5: the tower forward on raw pts, dirs (N, 3) f32, embedding in the
    kernel; heads (sigma, rgb, feat, transient (N, 5)), those of `mode`,
    in f32. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    mode = _check_mode(p, mode)
    if not _kernel_device(pts):
        return field_fwd_plain(p, mode, pts, dirs)
    spec, dev, f32 = p.spec, pts.device, torch.float32
    n = pts.shape[0]
    check_packed(p, dev)
    check(pts, "pts", (n, 3), f32, dev)
    if mode != SIGMA:
        check(dirs, "dirs", (n, 3), f32, dev)
    return _launch_fwd(field_fwd, p, mode, pts, dirs, f32, True)


def field_bwd(p: PackedField, mode: int, pts, dirs, g_sigma, g_rgb, g_feat,
              g_trans=None, need_dw=False):
    """K6: recompute the tower on raw inputs and backprop the f32 head
    cotangents to (d_pts (N, 3), d_dirs (N, 3) | None) in f32 and, with
    need_dw, the weights' f32 gradients in blob order (else None)."""
    mode = _check_mode(p, mode)
    if not _kernel_device(pts):
        return field_bwd_plain(p, mode, pts, dirs, g_sigma, g_rgb, g_feat,
                               g_trans, need_dw)
    spec, dev, f32 = p.spec, pts.device, torch.float32
    n = pts.shape[0]
    check_packed(p, dev)
    check(pts, "pts", (n, 3), f32, dev)
    if mode != SIGMA:
        check(dirs, "dirs", (n, 3), f32, dev)
    g = (g_sigma, g_rgb, g_feat, g_trans)
    _check_cotangents(spec, mode, n, f32, dev, *g)
    lib = build.library("fused_field")
    return _launch_bwd(field_bwd, lib.nefes_field_bwd_raw, p, mode, pts,
                       dirs, g, 3, 3, f32, need_dw)


def field_dw(p: PackedField, mode: int, ops: torch.Tensor,
             tile_b: torch.Tensor, rows: int,
             part: torch.Tensor) -> torch.Tensor:
    """The dW kernel of K2/K6 with need_dw on one chunk of `rows` rows: ops
    the chunk's operands (dw_operands' layout, pack dtype), tile_b its
    tiles' f32 head bias sums (tiles, nb); adds the chunk's weight gradients
    into part (slices, nw + nb) f32, each row slice's into its row, and
    returns part. The kernel on a CUDA tensor; on a CPU tensor the plain
    version, added into part[0]."""
    mode = _check_mode(p, mode)
    if not _kernel_device(ops):
        part[0] += field_dw_plain(p, mode, ops, tile_b, rows)
        return part
    spec, dev = p.spec, ops.device
    lib = build.library("fused_field")
    need = rows * lib.nefes_field_dw_row_elems(mode, *dims(spec))
    check(ops, "ops", (ops.numel(),), spec.torch_dtype, dev)
    check(tile_b, "tile_b", tile_b.shape, torch.float32, dev)
    check(part, "part", part.shape, torch.float32, dev)
    nb = p.b.numel()
    if (ops.numel() < need or tile_b.dim() != 2 or tile_b.shape[1] != nb
            or tile_b.shape[0] < -(-rows // TILE_ROWS) or part.dim() != 2
            or part.shape[1] != p.w.numel() + nb):
        raise ValueError(f"field_dw: the buffers do not fit {rows} rows")
    err = dw_launch(lib, p, mode, ops, tile_b, rows, part, _stream())
    field_dw.launches += 1
    raise_on(err, "field_dw")
    return part


for _k in (field_fwd_pre, field_bwd_pre, field_fwd, field_bwd):
    _k.launches = 0
    _k.transient_launches = 0
for _k in (field_bwd_pre, field_bwd):
    _k.dw_launches = 0
field_dw.launches = 0


class _Field(torch.autograd.Function):
    """The tower, differentiable in its inputs (the embeddings, K1/K2, or,
    raw, the points and directions, K5/K6) and, with need_dw, in the
    packed blobs w and b: their gradients are the backward's f32 ones,
    the matrices' cast to the pack dtype (as the JAX kernel's VJP casts
    dW to the weights' dtype). Without need_dw the blobs get None."""

    @staticmethod
    def forward(ctx, raw, p, mode, need_dw, x, dirs, w, b):
        ctx.raw, ctx.p, ctx.mode, ctx.need_dw = raw, p, mode, need_dw
        ctx.save_for_backward(x, dirs)
        return (field_fwd if raw else field_fwd_pre)(p, mode, x, dirs)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_feat, g_trans):
        x, dirs = ctx.saved_tensors
        p, mode = ctx.p, ctx.mode
        hd = torch.float32 if ctx.raw else p.spec.torch_dtype
        n = x.shape[0]

        def ct(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=hd, device=x.device)
            return g.to(hd).contiguous()

        g_sigma = ct(g_sigma, (n,))
        if mode != SIGMA:
            g_rgb = ct(g_rgb, (n, 3))
            g_feat = ct(g_feat, (n, p.spec.feature_dim))
        if mode == TRANSIENT:
            g_trans = ct(g_trans, (n, 5))
        bwd = field_bwd if ctx.raw else field_bwd_pre
        d_x, d_dirs, dw = bwd(p, mode, x, dirs, g_sigma, g_rgb, g_feat,
                              g_trans, need_dw=ctx.need_dw)
        d_w = d_b = None
        if dw is not None:
            nw = p.w.numel()
            d_w, d_b = dw[:nw].to(p.spec.torch_dtype), dw[nw:]
        return None, None, None, None, d_x, d_dirs, d_w, d_b


def _mode(spec: FieldSpec, sigma_only: bool, output_transient: bool) -> int:
    if sigma_only:
        return SIGMA
    return TRANSIENT if (spec.transient and output_transient) else FULL


def _apply(raw: bool, spec: FieldSpec, packed: PackedField, lead, x, dirs,
           mode: int, need_dw: bool) -> dict:
    if need_dw and torch.is_grad_enabled() and not packed.w.requires_grad:
        raise ValueError("need_dw=True with weights packed without "
                         "autograd: pack_params under torch.no_grad() "
                         "gives a frozen field")
    sigma, rgb, feat, trans = _Field.apply(raw, packed, mode, need_dw, x,
                                           dirs, packed.w, packed.b)
    out = {"static_sigma": sigma.reshape(lead)}
    if rgb is not None:
        out["static_rgb"] = rgb.reshape(*lead, 3)
        out["static_feat"] = feat.reshape(*lead, spec.feature_dim)
    if trans is not None:
        out["transient_sigma"] = trans[:, 0].reshape(lead)
        out["transient_rgb"] = trans[:, 1:4].reshape(*lead, 3)
        out["transient_beta"] = trans[:, 4].reshape(lead)
    return out


def fused_field_apply_pre(spec: FieldSpec, packed: PackedField,
                          xyz_emb: torch.Tensor,
                          dir_emb: torch.Tensor | None = None,
                          sigma_only: bool = False,
                          output_transient: bool = True,
                          need_dw: bool = False) -> dict:
    """Drop-in for NeRFHNFF on EMBEDDED inputs: the signature of the
    model's field fns, returning the same named heads (the transient ones
    for a transient tower with output_transient) in the pack dtype.

    xyz_emb (..., E); dir_emb (..., Ed) broadcastable against xyz_emb's
    leading shape. Gradients reach the embeddings and, with need_dw, the
    packed weights."""
    mode = _mode(spec, sigma_only, output_transient)
    cd = spec.torch_dtype
    lead = xyz_emb.shape[:-1]
    emb = xyz_emb.reshape(-1, spec.emb_xyz).to(cd).contiguous()
    embd = None
    if mode != SIGMA:
        embd = dir_emb.expand(*lead, spec.emb_dir).reshape(
            -1, spec.emb_dir).to(cd).contiguous()
    return _apply(False, spec, packed, lead, emb, embd, mode, need_dw)


def fused_field_apply(spec: FieldSpec, packed: PackedField,
                      pts: torch.Tensor, dirs: torch.Tensor | None,
                      sigma_only: bool = False, output_transient: bool = True,
                      need_dw: bool = False) -> dict:
    """Drop-in for NeRFHNFF on RAW inputs (the JAX package's
    fused_field_apply): pts (..., 3), dirs (..., 3) broadcastable against
    pts (unused when sigma_only). Returns the named heads in f32.
    Gradients reach pts and dirs and, with need_dw, the packed weights."""
    mode = _mode(spec, sigma_only, output_transient)
    lead = pts.shape[:-1]
    x = pts.reshape(-1, 3).float().contiguous()
    d = (dirs.expand(*lead, 3).reshape(-1, 3).float().contiguous()
         if mode != SIGMA else None)
    return _apply(True, spec, packed, lead, x, d, mode, need_dw)
