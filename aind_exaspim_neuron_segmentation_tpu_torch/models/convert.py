"""Weights across frameworks: JAX variables -> PyTorch state_dict, BN fold.

Key correspondence (torch <- flax), the same table as the JAX package's
``models/convert.py``:

==============================================  =============================
``inc.double_conv.{0,3}``                        ``inc/{conv1,conv2}``
``inc.double_conv.{1,4}``                        ``inc/{bn1,bn2}``
``down{i}.maxpool_conv.1.double_conv.*``         ``down{i}/conv/*``
``up{i}.conv.double_conv.*``                     ``up{i}/conv/*``
``up{i}.up``  (ConvTranspose, trilinear=False)   ``up{i}/up``
``outc.conv``                                    ``outc``
==============================================  =============================

Flax Conv kernels (D, H, W, I, O) transpose to torch (O, I, D, H, W).
Flax ConvTranspose kernels are stored spatially flipped (the
``lax.conv_transpose`` convention), so they are flipped back and
transposed to torch's (I, O, D, H, W).
"""

import numpy as np
import torch


def _double_conv_entries(torch_prefix, flax_path):
    """(torch key prefix, flax path tuple, kind) rows for one DoubleConv."""
    rows = []
    for t_idx, f_name in (("0", "conv1"), ("3", "conv2")):
        rows.append((f"{torch_prefix}.{t_idx}", flax_path + (f_name,), "conv"))
    for t_idx, f_name in (("1", "bn1"), ("4", "bn2")):
        rows.append((f"{torch_prefix}.{t_idx}", flax_path + (f_name,), "bn"))
    return rows


def _layout(trilinear=True):
    rows = _double_conv_entries("inc.double_conv", ("inc",))
    for i in range(1, 5):
        rows += _double_conv_entries(
            f"down{i}.maxpool_conv.1.double_conv", (f"down{i}", "conv")
        )
    for i in range(1, 5):
        rows += _double_conv_entries(
            f"up{i}.conv.double_conv", (f"up{i}", "conv")
        )
        if not trilinear:
            rows.append((f"up{i}.up", (f"up{i}", "up"), "deconv"))
    rows.append(("outc.conv", ("outc",), "conv"))
    return rows


def _get(tree, path):
    node = tree
    for key in path:
        node = node[key]
    return node


def _tensor(a):
    # np.array copies: the tensor owns writable memory, never aliasing
    # (possibly read-only) caller arrays.
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def state_dict_from_jax_variables(variables, trilinear=True):
    """Convert the JAX package's UNet3D variables to this port's state_dict.

    ``variables`` is ``{"params", "batch_stats"}`` with array leaves (numpy,
    or anything ``np.asarray`` takes); the result loads strictly into
    ``UNet3D(fused_bn=False)``. A folded ``{"params"}`` tree (the JAX
    ``fold_batchnorm`` output) gives the conv-only state_dict of
    ``UNet3D(fused_bn=True)``.
    """
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd = {}
    for t_prefix, f_path, kind in _layout(trilinear):
        if kind == "bn":
            if stats is None:
                if f_path[-1] in _get(params, f_path[:-1]):
                    raise ValueError(
                        f"params hold BatchNorm {'/'.join(f_path)} but "
                        "there are no batch_stats"
                    )
                continue
            sd[f"{t_prefix}.weight"] = _tensor(_get(params, f_path + ("scale",)))
            sd[f"{t_prefix}.bias"] = _tensor(_get(params, f_path + ("bias",)))
            sd[f"{t_prefix}.running_mean"] = _tensor(
                _get(stats, f_path + ("mean",))
            )
            sd[f"{t_prefix}.running_var"] = _tensor(
                _get(stats, f_path + ("var",))
            )
            sd[f"{t_prefix}.num_batches_tracked"] = torch.tensor(0)
            continue
        k = np.asarray(_get(params, f_path + ("kernel",)))
        if kind == "conv":
            k = k.transpose(4, 3, 0, 1, 2)
        else:  # deconv
            k = k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        sd[f"{t_prefix}.weight"] = _tensor(k)
        sd[f"{t_prefix}.bias"] = _tensor(_get(params, f_path + ("bias",)))
    return sd


def fold_batchnorm(state_dict, trilinear=True, eps=1e-5):
    """Fold eval-mode BatchNorm into the preceding conv weight and bias.

    Eval BatchNorm is ``y = (x - mean) * g + bn_bias`` with
    ``g = weight / sqrt(var + eps)``; on a conv output that equals scaling
    the conv's output channels by ``g`` and replacing its bias with
    ``(bias - mean) * g + bn_bias``. Computed in float64 and cast to
    float32 with the JAX package's formula, so the folded tensors are
    bit-identical to its ``fold_batchnorm`` after the layout transpose.
    Returns the conv-only state_dict of ``UNet3D(fused_bn=True)``.
    """
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    folded = {}
    for t_prefix, _, kind in _layout(trilinear):
        if kind != "bn":
            for name in ("weight", "bias"):
                folded[f"{t_prefix}.{name}"] = sd[f"{t_prefix}.{name}"]
            continue
        # DoubleConv slots: conv 0 -> bn 1, conv 3 -> bn 4
        head, idx = t_prefix.rsplit(".", 1)
        conv = f"{head}.{int(idx) - 1}"
        g = sd[f"{t_prefix}.weight"].double() / torch.sqrt(
            sd[f"{t_prefix}.running_var"].double() + eps
        )
        w = sd[f"{conv}.weight"].double()
        b = sd[f"{conv}.bias"].double()
        folded[f"{conv}.weight"] = (w * g[:, None, None, None, None]).float()
        folded[f"{conv}.bias"] = (
            (b - sd[f"{t_prefix}.running_mean"].double()) * g
            + sd[f"{t_prefix}.bias"].double()
        ).float()
    return folded


def load_pth(path, module):
    """Load a reference ``.pth`` state_dict into ``module`` (strict)."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state_dict, strict=True)
    return module
