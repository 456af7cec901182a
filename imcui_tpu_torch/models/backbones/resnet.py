"""ResNet backbones (torchvision layout) on NCHW tensors. Counterpart of
``imcui_tpu/models/backbones/resnet.py``: the basic block (SFD2's and
FIRe's), ResNet-18 on it (``init_resnet18``, ``resnet18_apply``: CosPlace's
``backbone="ResNet18"``), the bottleneck ResNet-50/101 with its stem,
``resnet_apply`` to stride 32, the feature pyramid that DKM reads ({1:
image, 2: stem, 4: layer1, 8: layer2, 16: layer3, 32: layer4}) and GeM
pooling.
"""

import torch

from ..layers import (batch_norm_inference, conv2d, init_bn, init_conv,
                      max_pool3_s2, relu)

BOTTLENECK_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def init_basic_block(gen, cin, cout, stride):
    """conv1/bn1, conv2/bn2 (3 × 3, bias-free) and, where the stride or
    the width changes, a 1 × 1 ``downsample`` (children 0 and 1)."""
    p = {"conv1": init_conv(gen, 3, 3, cin, cout, bias=False),
         "bn1": init_bn(cout),
         "conv2": init_conv(gen, 3, 3, cout, cout, bias=False),
         "bn2": init_bn(cout)}
    if stride != 1 or cin != cout:
        p["downsample"] = {"0": init_conv(gen, 1, 1, cin, cout, bias=False),
                           "1": init_bn(cout)}
    return p


def _shortcut(p, x, stride):
    if "downsample" not in p:
        return x
    return batch_norm_inference(
        p["downsample"]["1"], conv2d(p["downsample"]["0"], x, stride=stride))


def basic_block(p, x, stride):
    """relu(x' + bn2(conv2(relu(bn1(conv1(x)))))), x' the downsampled x
    where the block has ``downsample``. x: (B, C, H, W)."""
    y = relu(batch_norm_inference(p["bn1"],
                                  conv2d(p["conv1"], x, stride=stride)))
    y = batch_norm_inference(p["bn2"], conv2d(p["conv2"], y))
    return relu(_shortcut(p, x, stride) + y)


LAYERS_18 = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


def init_resnet18(gen):
    """conv1/bn1 (7 × 7 stem) and layer1-4 of two basic blocks each."""
    params = {"conv1": init_conv(gen, 7, 7, 3, 64, bias=False),
              "bn1": init_bn(64)}
    cin = 64
    for li, (cout, blocks, stride) in enumerate(LAYERS_18, start=1):
        params[f"layer{li}"] = {
            str(bi): init_basic_block(gen, cin if bi == 0 else cout, cout,
                                      stride if bi == 0 else 1)
            for bi in range(blocks)}
        cin = cout
    return params


def resnet18_apply(params, x):
    """x: (B, 3, H, W) → (B, 512, H/32, W/32): the stem, torchvision's
    3 × 3 stride-2 pool, then the four layers."""
    x = relu(batch_norm_inference(params["bn1"],
                                  conv2d(params["conv1"], x, stride=2)))
    x = max_pool3_s2(x)
    for li, (_, blocks, stride) in enumerate(LAYERS_18, start=1):
        for bi in range(blocks):
            x = basic_block(params[f"layer{li}"][str(bi)], x,
                            stride if bi == 0 else 1)
    return x


def init_bottleneck(gen, cin, planes, stride):
    """1 × 1 → 3 × 3 (stride) → 1 × 1 to 4·planes, bias-free, each with
    BN; a 1 × 1 ``downsample`` where the stride or the width changes."""
    cout = planes * 4
    p = {"conv1": init_conv(gen, 1, 1, cin, planes, bias=False),
         "bn1": init_bn(planes),
         "conv2": init_conv(gen, 3, 3, planes, planes, bias=False),
         "bn2": init_bn(planes),
         "conv3": init_conv(gen, 1, 1, planes, cout, bias=False),
         "bn3": init_bn(cout)}
    if stride != 1 or cin != cout:
        p["downsample"] = {"0": init_conv(gen, 1, 1, cin, cout, bias=False),
                           "1": init_bn(cout)}
    return p


def bottleneck_block(p, x, stride):
    y = relu(batch_norm_inference(p["bn1"], conv2d(p["conv1"], x)))
    y = relu(batch_norm_inference(p["bn2"],
                                  conv2d(p["conv2"], y, stride=stride)))
    y = batch_norm_inference(p["bn3"], conv2d(p["conv3"], y))
    return relu(_shortcut(p, x, stride) + y)


def init_resnet(gen, depth="resnet50"):
    params = {"conv1": init_conv(gen, 7, 7, 3, 64, bias=False),
              "bn1": init_bn(64)}
    cin = 64
    for li, n in enumerate(BOTTLENECK_BLOCKS[depth], start=1):
        planes = 64 * 2 ** (li - 1)
        layer = {}
        for bi in range(n):
            layer[str(bi)] = init_bottleneck(
                gen, cin, planes, 2 if (bi == 0 and li > 1) else 1)
            cin = planes * 4
        params[f"layer{li}"] = layer
    return params


def _stages(params, x, depth):
    """The stem's output, then each layer's, of (B, 3, H, W)."""
    y = relu(batch_norm_inference(params["bn1"],
                                  conv2d(params["conv1"], x, stride=2)))
    yield y
    y = max_pool3_s2(y)
    for li, n in enumerate(BOTTLENECK_BLOCKS[depth], start=1):
        layer = params[f"layer{li}"]
        for bi in range(n):
            y = bottleneck_block(layer[str(bi)], y,
                                 2 if (bi == 0 and li > 1) else 1)
        yield y


def resnet_apply(params, x, depth="resnet50"):
    """x: (B, 3, H, W) → (B, 2048, H/32, W/32)."""
    *_, y = _stages(params, x, depth)
    return y


def resnet_pyramid_apply(params, x, depth="resnet50"):
    """DKM's feature pyramid of one (3, H, W) view: {1: the image, 2: the
    stem's ReLU, 4, 8, 16, 32: layers 1-4}, each (C, h, w)."""
    feats = {1: x}
    for i, y in enumerate(_stages(params, x[None], depth), start=1):
        feats[2 ** i] = y[0]
    return feats


def gem_pool(x, p=3.0, eps=1e-6):
    """Generalised-mean pooling of (B, C, H, W) over its spatial dims →
    (B, C); ``p`` may be a learned scalar tensor."""
    p = torch.as_tensor(p, dtype=torch.float32, device=x.device).reshape(())
    return (x.clamp_min(eps) ** p).mean((2, 3)) ** (1.0 / p)
