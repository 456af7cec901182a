"""ResNet's basic block (torchvision layout), what SFD2 builds on.
Counterpart of the first part of ``imcui_tpu/models/backbones/resnet.py``
(``init_bn``, ``init_basic_block``, ``basic_block``) on NCHW tensors. The
rest of that module (ResNet-18/50, the bottleneck block, ``gem_pool``,
the feature pyramid) has no caller in this package yet.
"""

from ..layers import batch_norm_inference, conv2d, init_bn, init_conv, relu


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


def basic_block(p, x, stride):
    """relu(x' + bn2(conv2(relu(bn1(conv1(x)))))), x' the downsampled x
    where the block has ``downsample``. x: (B, C, H, W)."""
    y = relu(batch_norm_inference(p["bn1"],
                                  conv2d(p["conv1"], x, stride=stride)))
    y = batch_norm_inference(p["bn2"], conv2d(p["conv2"], y))
    if "downsample" in p:
        x = batch_norm_inference(
            p["downsample"]["1"],
            conv2d(p["downsample"]["0"], x, stride=stride))
    return relu(x + y)
