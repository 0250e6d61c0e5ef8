"""The model's weights from the seed, made on the device.

:func:`layout` lists every parameter of a configuration as a path, a shape
and its fan-in, in the layout the program takes (linear weights ``(out,
in)``, the program's key names). :func:`make` draws all of them, for every
member at once, in one ``torch.rand`` call on a generator on the card, and
scales each leaf to U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the observation and
label scales start at the configuration's ``constant_std``, as the program's
initializer sets them. Both sides get the same values: the program as its
nested tree (:func:`to_tree`), the reference as the flat dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], int]]  # (path, shape, fan_in; 0 = a constant)


def layout(cfg: Dict, n_time: int) -> Layout:
    c, m = cfg["config"], cfg["model"]
    blocks = [(name, int(dim)) for name, dim in m["blocks"]]
    L = sum(dim for _, dim in blocks)
    K, Fn, W, P = int(c["obs_dim"]), int(c["n_filters"]), int(c["filter_size"]), int(c["pool_size"])
    Hc, D, H, U = int(c["cnn_hidden_dim"]), int(c["ode_state_dim"]), int(c["ode_hidden_dim"]), int(c["u_hidden_dim"])
    flat = (n_time - (W - 1) - (P - 1)) * Fn
    out: Layout = []

    def linear(path, n_in, n_out, bias=True):
        out.append((f"{path}/W", (n_out, n_in), n_in))
        if bias:
            out.append((f"{path}/b", (n_out,), n_in))

    out.append(("encoder/conv_W", (Fn, K, W), K * W))
    out.append(("encoder/conv_b", (Fn,), K * W))
    linear("encoder/lin", flat, Hc)
    linear("encoder/z_loc", Hc, L)
    linear("encoder/z_scale", Hc, L)
    linear("decoder/ode/latent_to_ode/0", L, H)
    linear("decoder/ode/latent_to_ode/1", H, D)
    linear("decoder/ode/dyn_hidden", L + 1, H)
    linear("decoder/ode/prod", H, D)
    linear("decoder/ode/degr", H, D)
    for q in ("q50", "q75", "q25"):
        linear(f"decoder/{q}", D, K, bias=False)
    out.append(("decoder/constant_std", (K, n_time), 0))
    labels = [(n, int(d), k, b) for n, d, k, b in m["labels"]]
    dims = dict(blocks)
    if m["prior"] == "separate":
        for name, dim, _, block in labels:
            for head in (0, 1):
                linear(f"priors/{block}/heads/{head}", dim, dims[block])
    else:
        z_u = sum(dims[b] for b, _ in blocks[:-1])
        for head in (0, 1):
            linear(f"priors/z_u/heads/{head}", sum(d for _, d, _, _ in labels), z_u)
    for name, dim, kind, block in labels:
        linear(f"aux/{name}/hidden/0", dims[block], U)
        for head in range(2 if kind == "continuous" else 1):
            linear(f"aux/{name}/heads/{head}", U, dim)
        if kind == "continuous":
            out.append((f"aux_std/{name}", (dim,), 0))
    return out


def make(cfg: Dict, n_time: int, seed: int, device, members: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, float32 on ``device``: one flat dict,
    each leaf with a leading member axis when ``members`` is given."""
    lay = layout(cfg, n_time)
    lead = () if members is None else (members,)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in lay]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    n = members or 1
    u = torch.rand((n, sum(sizes)), generator=gen, device=device) * 2.0 - 1.0
    const = float(cfg["config"]["constant_std"])
    out, at = {}, 0
    for (path, shape, fan_in), size in zip(lay, sizes):
        block = u[:, at:at + size].reshape(lead + shape if members else shape)
        at += size
        out[path] = torch.full_like(block, const) if fan_in == 0 else (block * fan_in ** -0.5).contiguous()
    return out


def to_tree(flat: Dict[str, torch.Tensor]):
    """The flat dict as the program's nested tree: a path's segments are
    dict keys, and the segments of a list (``latent_to_ode/0``,
    ``heads/1``) are its indices."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        out = {k: lists(v) for k, v in node.items()}
        if "heads" in out:
            out.setdefault("hidden", [])  # an MLP with no hidden layer (the priors)
        return out

    tree = lists(tree)
    # the program's tree has these groups even where a model leaves them empty
    for group in ("priors", "aux", "aux_std"):
        tree.setdefault(group, {})
    return tree
