"""Analytic operation and byte counts of MedNeXt, from its shapes alone.

The yardstick of the MedNeXt cell's rooflines and MFU. Every count
follows from the published architecture (MedNeXt v1: a ``1^3`` stem,
blocks of a depthwise ``k^3`` conv, a per-channel GroupNorm and a
``1^3`` -> GELU -> ``1^3`` inverted bottleneck, stride-2 down and
transposed up blocks with ``1^3`` residual convs, a ``1^3`` transposed
output conv) and the patch geometry; none depends on how the program
computes it.

* :func:`blocks` lists the 62 blocks of MedNeXt-L (54 plain, 4 down, 4
  up) in the order they run, with their widths and voxel counts.
* :func:`conv_layers` lists every conv and transposed conv of one patch's
  forward in the order it runs, each tagged with its ``role`` (``stem``,
  ``dw``, ``mlp``, ``res``, ``out``).
* FLOPs are 2 x multiply-adds; bias adds, norms, GELU and the residual
  adds are not counted. A transposed conv's multiply-adds are its weight
  times its input voxels; a conv's, its weight times its output voxels; a
  depthwise weight has one input channel a group.
* Minimal bytes count each operand read once and each result written
  once, in the activation dtype's width: for the MLP, the block's
  ``C``-wide input and output and both weights, never the ``rC``-wide
  hidden tensor, so the count is of the work whatever kernel computes it.
"""

STAGES = 4
PUBLISHED_L = (3, 4, 8, 8, 8, 8, 8, 4, 3)


def blocks(patch=128, n_channels=32, exp_r=PUBLISHED_L,
           block_counts=PUBLISHED_L, kernel_size=5, **_):
    """One dict a block, in the order the forward runs them: ``mode``
    (``same``, ``down``, ``up``), ``cin``, ``cout``, ``ratio``, ``k``,
    ``vin`` (input voxels of one patch) and ``vmid`` (voxels of the
    depthwise conv's output, which the norm and the MLP run over)."""
    c = [n_channels * 2 ** i for i in range(STAGES + 1)]
    side = [patch // 2 ** i for i in range(STAGES + 1)]
    out = []

    def add(mode, cin, cout, r, n_in, n_mid):
        out.append(dict(mode=mode, cin=cin, cout=cout, ratio=r,
                        k=kernel_size, vin=n_in ** 3, vmid=n_mid ** 3))

    for i in range(STAGES):
        for _ in range(block_counts[i]):
            add("same", c[i], c[i], exp_r[i], side[i], side[i])
        add("down", c[i], c[i + 1], exp_r[i + 1], side[i], side[i + 1])
    for _ in range(block_counts[4]):
        add("same", c[4], c[4], exp_r[4], side[4], side[4])
    for j in range(STAGES):
        i = STAGES - 1 - j
        add("up", c[i + 1], c[i], exp_r[5 + j], side[i + 1],
            2 * side[i + 1] - 1)
        for _ in range(block_counts[5 + j]):
            add("same", c[i], c[i], exp_r[5 + j], side[i], side[i])
    return out


def block_patches(batch=1, block_counts=PUBLISHED_L, **_):
    """(blocks run) x (patches) of one forward of ``batch`` patches: the
    program's ``MedNeXt.block_patches`` counter."""
    return batch * (sum(block_counts) + 2 * STAGES)


def conv_layers(patch=128, n_channels=32, in_channels=1, out_channels=3,
                **widths):
    """Every conv of one ``patch**3`` forward, in the order it runs, as
    dicts with ``role``, ``cin``, ``cout``, ``taps``, ``vin``, ``vout``
    (input and output voxels of one patch), ``groups`` and
    ``transposed``; every conv has a bias."""
    layers = []

    def conv(role, cin, cout, k, vin, vout, groups=1, transposed=False):
        layers.append(dict(role=role, cin=cin, cout=cout, taps=k ** 3,
                           vin=vin, vout=vout, groups=groups,
                           transposed=transposed))

    conv("stem", in_channels, n_channels, 1, patch ** 3, patch ** 3)
    for b in blocks(patch, n_channels, **widths):
        c, v, m = b["cin"], b["vin"], b["vmid"]
        conv("dw", c, c, b["k"], v, m, groups=c, transposed=b["mode"] == "up")
        conv("mlp", c, b["ratio"] * c, 1, m, m)
        conv("mlp", b["ratio"] * c, b["cout"], 1, m, m)
        if b["mode"] != "same":
            conv("res", c, b["cout"], 1, v, m, transposed=b["mode"] == "up")
    conv("out", n_channels, out_channels, 1, patch ** 3, patch ** 3,
         transposed=True)
    return layers


def layer_flops(l):
    """FLOPs (2 x multiply-adds) of one conv of one patch."""
    voxels = l["vin"] if l["transposed"] else l["vout"]
    return 2 * l["taps"] * l["cin"] // l["groups"] * l["cout"] * voxels


def conv_flops(layers):
    """FLOPs of the convs of one patch."""
    return sum(layer_flops(l) for l in layers)


def weight_elems(l):
    """Weight and bias elements of one conv."""
    return l["taps"] * l["cin"] // l["groups"] * l["cout"] + l["cout"]


def conv_bytes(layers, batch, itemsize=2):
    """Minimal bytes of a batch through every conv: the input, the
    weights and bias read, the output written."""
    return sum(batch * (l["cin"] * l["vin"] + l["cout"] * l["vout"])
               * itemsize + weight_elems(l) * itemsize for l in layers)


def dwconv_work(patch=128, batch=1, itemsize=2, **widths):
    """``[(flops, bytes), ...]`` of every depthwise conv of one forward of
    ``batch`` patches (stride 1, stride 2 and transposed)."""
    return [(batch * layer_flops(l), conv_bytes([l], batch, itemsize))
            for l in conv_layers(patch, **widths) if l["role"] == "dw"]


def mlp_work(patch=128, batch=1, itemsize=2, **widths):
    """``[(flops, bytes), ...]`` of every block's ``conv2 -> GELU ->
    conv3`` of one forward of ``batch`` patches: the FLOPs of both convs;
    the bytes of the ``C``-wide input read, the output written and both
    convs' weights and biases read (the hidden tensor is not counted)."""
    out = []
    for b in blocks(patch, **widths):
        c, r, m = b["cin"], b["ratio"], b["vmid"]
        flops = 2 * m * (c * r * c + r * c * b["cout"])
        weights = c * r * c + r * c + r * c * b["cout"] + b["cout"]
        nbytes = (batch * m * (c + b["cout"]) + weights) * itemsize
        out.append((batch * flops, nbytes))
    return out


def norm_work(patch=128, batch=1, itemsize=2, **widths):
    """``[(flops, bytes), ...]`` of every GroupNorm of one forward of
    ``batch`` patches: no FLOPs counted; the map read once, written once,
    and its scale and shift read."""
    return [(0, (2 * batch * b["cin"] * b["vmid"] + 2 * b["cin"])
             * itemsize) for b in blocks(patch, **widths)]


def forward_flops(patch=128, **widths):
    """FLOPs of one patch's forward: every conv and transposed conv."""
    return conv_flops(conv_layers(patch, **widths))
