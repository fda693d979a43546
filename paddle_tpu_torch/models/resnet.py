"""ResNet family built from fluid-style layers (port of
``paddle_tpu/models/resnet.py``).

Mirrors the reference's benchmark model (``benchmark/fluid/models/resnet.py``
conv_bn_layer / bottleneck structure); the convolutions and batch norms
run on cuDNN (``ops/conv_ops.py``).
"""

import paddle_tpu_torch as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = fluid.layers.conv2d(input=input, num_filters=num_filters,
                               filter_size=filter_size, stride=stride,
                               padding=(filter_size - 1) // 2, groups=groups,
                               act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, act="relu",
                          is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, is_test=is_test)
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, act="relu", is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride, act="relu",
                          is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, is_test=is_test)
    return fluid.layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_fn, input, ch_out, count, stride, is_test=False):
    out = block_fn(input, ch_out, stride, is_test=is_test)
    for _ in range(count - 1):
        out = block_fn(out, ch_out, 1, is_test=is_test)
    return out


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    """ResNet-50/101/152 (config #2 of BASELINE.md)."""
    cfg = {50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_fn = cfg[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, act="relu", is_test=is_test)
    pool1 = fluid.layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                                pool_padding=1, pool_type="max")
    res1 = layer_warp(block_fn, pool1, 64, stages[0], 1, is_test=is_test)
    res2 = layer_warp(block_fn, res1, 128, stages[1], 2, is_test=is_test)
    res3 = layer_warp(block_fn, res2, 256, stages[2], 2, is_test=is_test)
    res4 = layer_warp(block_fn, res3, 512, stages[3], 2, is_test=is_test)
    pool2 = fluid.layers.pool2d(input=res4, pool_type="avg",
                                global_pooling=True)
    return fluid.layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, act="relu", is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = fluid.layers.pool2d(input=res3, pool_type="avg",
                               global_pooling=True)
    return fluid.layers.fc(input=pool, size=class_dim, act="softmax")
