"""VGG16 (reference ``benchmark/fluid/models/vgg.py`` /
``tests/book`` image_classification vgg16_bn_drop; port of
``paddle_tpu/models/vgg.py``).  Test-mode behavior comes from
``Program.clone(for_test=True)`` flipping is_test on batch_norm/dropout,
as in the reference."""

import paddle_tpu_torch as fluid


def _vgg16(input, class_dim, fc_dim):
    def conv_block(ipt, num_filter, groups):
        return fluid.nets.img_conv_group(
            input=ipt, conv_num_filter=[num_filter] * groups,
            pool_size=2, conv_padding=1, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            pool_stride=2, pool_type="max")

    net = input
    for num_filter, groups in ((64, 2), (128, 2), (256, 3),
                               (512, 3), (512, 3)):
        net = conv_block(net, num_filter, groups)

    drop = fluid.layers.dropout(x=net, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=fc_dim, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu")
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=fc_dim, act=None)
    return fluid.layers.fc(input=fc2, size=class_dim, act="softmax")


def vgg16_bn_drop(input, class_dim=10):
    """Book-chapter cifar variant (512-wide fc head)."""
    return _vgg16(input, class_dim, fc_dim=512)


def vgg16_imagenet(input, class_dim=1000):
    """Full-width VGG16 (4096-wide fc head) — the configuration behind
    the reference's fp16 inference benchmark
    (``paddle/contrib/float16/float16_inference_demo.py:138-162``,
    numbers in ``float16_benchmark.md``)."""
    return _vgg16(input, class_dim, fc_dim=4096)
