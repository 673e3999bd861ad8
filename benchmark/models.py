"""Weights and inputs made from the seed, on the device, for both sides:
the program's modules (nefes_tpu_torch) and the plain reference's. Each
weight tensor is drawn by its name, so the two sides, whose modules name
their weights alike, get the same values whatever order they register
them in."""

from __future__ import annotations

import torch

# roles of the generators drawn from one seed
FIELD, APR, FEATNET, IMAGES, POSES, SAMPLE, BATCH, STEPS = range(1, 9)


def generator(seed: int, role: int, device) -> torch.Generator:
    """A generator on `device` for one role of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 16 + role) % (2 ** 63))


# He's gain for a convolution before a ReLU with uniform weights: bound
# sqrt(6 / fan_in) keeps the activations' scale from layer to layer
RELU_GAIN = 6 ** 0.5


@torch.no_grad()
def fill_uniform_(module: torch.nn.Module, seed: int, role: int,
                  conv_gain: float = 1.0) -> None:
    """Every convolution and linear weight of `module` and its bias
    uniform within PyTorch's default fan-in bound, the convolutions'
    weights within conv_gain times it, from one draw on the module's
    device, the tensors taken in the order of their names; normalisation
    layers keep their defaults."""
    named = dict(module.named_parameters())
    targets = []
    for name in sorted(named):
        p = named[name]
        if name.endswith("weight") and p.ndim >= 2:
            bound = p[0].numel() ** -0.5
            targets.append((p, bound * (conv_gain if p.ndim == 4 else 1.0)))
            bias = named.get(name[:-len("weight")] + "bias")
            if bias is not None:
                targets.append((bias, bound))
    if not targets:
        return
    dev = targets[0][0].device
    flat = torch.rand(sum(p.numel() for p, _ in targets),
                      generator=generator(seed, role, dev), device=dev)
    off = 0
    for p, b in targets:
        n = p.numel()
        p.copy_(((flat[off:off + n] * 2 - 1) * b).reshape(p.shape))
        off += n


def fill_dfnet_(net, seed: int) -> None:
    """DFNet's weights (the VGG16 trunk, 13 convolutions with no
    normalisation, and the adaptation blocks): fill_uniform_ with He's
    gain on the convolutions, so that the pose head and the features see
    activations of the image's scale and not 0.41 of it per layer."""
    fill_uniform_(net, seed, FEATNET, conv_gain=RELU_GAIN)


@torch.no_grad()
def fill_mstransformer_(net, seed: int) -> None:
    """MS-Transformer's weights: convolutions and linear layers as
    fill_uniform_, the position embeddings U[0, 1), the scene queries
    N(0, 1), the stacked heads' kernels uniform within their fan-in bound
    and their biases 0 (the program's own initialisers)."""
    fill_uniform_(net, seed, APR)
    named = dict(net.named_parameters())
    g = generator(seed, APR + 16, next(net.parameters()).device)
    for name in sorted(named):
        p, leaf = named[name], name.rsplit(".", 1)[-1]
        if leaf in ("row_embed", "col_embed"):
            p.copy_(torch.rand(p.shape, generator=g, device=g.device))
        elif leaf.startswith("query_embed"):
            p.copy_(torch.randn(p.shape, generator=g, device=g.device))
        elif leaf in ("fc_h_kernel", "fc_o_kernel"):
            b = p.shape[1] ** -0.5
            p.copy_(torch.rand(p.shape, generator=g, device=g.device)
                    * (2 * b) - b)
        elif leaf in ("fc_h_bias", "fc_o_bias"):
            p.zero_()


@torch.no_grad()
def aim_mstransformer_(net, pose34: torch.Tensor) -> None:
    """Point a random MS-Transformer at `pose34` (as the program's smoke
    test aims it): the scene logits' weights zero, so that scene 0 is
    chosen for every query, and each head's output kernels scaled by
    1e-2 with the pose's translation and quaternion as their biases."""
    R = pose34[:, :3]
    w = torch.sqrt(torch.clamp(1 + R[0, 0] + R[1, 1] + R[2, 2], min=1e-8)) / 2
    q = torch.stack([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])
    net.scene_embed.weight.zero_()
    for head, bias in ((net.regressor_head_t, pose34[:, 3]),
                       (net.regressor_head_rot, q)):
        head.fc_o_kernel.mul_(1e-2)
        head.fc_o_bias.copy_(bias.expand_as(head.fc_o_bias))


def look_pose(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n camera poses (n, 3, 4): a rotation of up to 0.3 rad about a
    random axis and a translation in [-0.5, 0.5]^3."""
    u = torch.rand((n, 7), generator=gen, device=gen.device).to(device)
    axis = u[:, :3] - 0.5
    axis = axis / axis.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    angle = 0.3 * u[:, 3:4]
    K = torch.zeros((n, 3, 3), device=device)
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    R = torch.eye(3, device=device) + s * K + (1 - c) * (K @ K)
    return torch.cat([R, (u[:, 4:7] - 0.5)[..., None]], dim=-1)


@torch.no_grad()
def aim_dfnet_(net, pose34: torch.Tensor) -> None:
    """Point a random DFNet's pose head at `pose34`: its weights scaled by
    1e-2 and its bias the pose, so that every image gives a pose near it
    (the program's smoke test aims its DFNet so)."""
    net.fc_pose.weight.mul_(1e-2)
    net.fc_pose.bias.copy_(pose34.reshape(12))


def images(seed: int, n: int, H: int, W: int, device) -> torch.Tensor:
    """n query images (n, H, W, 3) in [0, 1]: smooth colour fields (noise at
    an eighth of the size, upsampled) with fine noise on top."""
    gen = generator(seed, IMAGES, device)
    coarse = torch.rand((n, 3, max(H // 8, 2), max(W // 8, 2)),
                        generator=gen, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(H, W),
                                          mode="bilinear",
                                          align_corners=False)
    fine = torch.rand((n, 3, H, W), generator=gen, device=device)
    return (0.8 * img + 0.2 * fine).permute(0, 2, 3, 1).contiguous()


def sample(seed: int, population: int, k: int) -> list[int]:
    """k distinct indices of range(population), drawn from the seed, with
    population - 1 (the last one) always among them."""
    if population <= 0:
        return []
    g = torch.Generator().manual_seed((int(seed) * 16 + SAMPLE) % (2 ** 63))
    rest = torch.randperm(max(population - 1, 0), generator=g).tolist()
    return sorted([population - 1] + rest[:max(k - 1, 0)])
