"""CNN model zoo: AlexNet, ResNet-50, InceptionV3, CANDLE Uno — a copy of
the JAX package's ``models/cnn.py``, builder call for builder call, against
the port's FFModel.

Reference apps: examples/cpp/AlexNet/alexnet.cc:34-130 (canonical train
loop), examples/cpp/ResNet/resnet.cc (BottleneckBlock), examples/cpp/
InceptionV3/inception.cc (branchy graph — the op-parallel search showcase).
All NCHW through the native builder API.
"""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import ActiMode, PoolType


def alexnet(ff, batch_size: int, num_classes: int = 1000):
    """reference: alexnet.cc:43-72 (229x229 input variant)."""
    x = ff.create_tensor([batch_size, 3, 229, 229], name="input")
    t = ff.conv2d(x, 64, 11, 11, 4, 4, 2, 2, ActiMode.AC_MODE_RELU, name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU, name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU, name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU, name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU, name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool5")
    t = ff.flat(t)
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU, name="fc6")
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU, name="fc7")
    t = ff.dense(t, num_classes, name="fc8")
    return x, t


def alexnet_cifar10(ff, batch_size: int):
    """bootcamp_demo CIFAR10 AlexNet (32x32), the accuracy-gate config."""
    x = ff.create_tensor([batch_size, 3, 32, 32], name="input")
    t = ff.conv2d(x, 64, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU, name="conv1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU, name="conv2")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool2")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU, name="conv3")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool3")
    t = ff.flat(t)
    t = ff.dense(t, 512, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 10, name="fc2")
    return x, t


def _bottleneck(ff, t, out_channels, stride, i, downsample):
    """reference: resnet.cc BottleneckBlock — 1x1 reduce, 3x3, 1x1 expand,
    projection shortcut on stride/width change; BN after each conv."""
    shortcut = t
    c = out_channels
    b = ff.conv2d(t, c, 1, 1, 1, 1, 0, 0, name=f"res{i}_br1x1a")
    b = ff.batch_norm(b, relu=True, name=f"res{i}_bn1")
    b = ff.conv2d(b, c, 3, 3, stride, stride, 1, 1, name=f"res{i}_br3x3")
    b = ff.batch_norm(b, relu=True, name=f"res{i}_bn2")
    b = ff.conv2d(b, 4 * c, 1, 1, 1, 1, 0, 0, name=f"res{i}_br1x1b")
    b = ff.batch_norm(b, relu=False, name=f"res{i}_bn3")
    if downsample:
        shortcut = ff.conv2d(t, 4 * c, 1, 1, stride, stride, 0, 0,
                             name=f"res{i}_proj")
        shortcut = ff.batch_norm(shortcut, relu=False, name=f"res{i}_bnp")
    out = ff.add(b, shortcut, name=f"res{i}_add")
    return ff.relu(out, name=f"res{i}_relu")


def resnet50(ff, batch_size: int, num_classes: int = 1000,
             image_size: int = 224):
    x = ff.create_tensor([batch_size, 3, image_size, image_size], name="input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    i = 0
    for stage, (c, n, s) in enumerate([(64, 3, 1), (128, 4, 2),
                                       (256, 6, 2), (512, 3, 2)]):
        for blk in range(n):
            stride = s if blk == 0 else 1
            t = _bottleneck(ff, t, c, stride, i, downsample=(blk == 0))
            i += 1
    # global average pool
    h = t.dims[2]
    t = ff.pool2d(t, h, h, 1, 1, 0, 0, PoolType.POOL_AVG, name="gap")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return x, t


def _inception_a(ff, t, pool_c, i):
    """reference: inception.cc InceptionA — 4 branches concat'd."""
    b1 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b1")
    b2 = ff.conv2d(t, 48, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b2a")
    b2 = ff.conv2d(b2, 64, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b2b")
    b3 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b3a")
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b3b")
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b3c")
    b4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"iA{i}_b4a")
    b4 = ff.conv2d(b4, pool_c, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_RELU,
                   name=f"iA{i}_b4b")
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"iA{i}_cat")


def _inception_b(ff, t, i):
    """Grid reduction 35->17 (reference: inception.cc InceptionB)."""
    r = ActiMode.AC_MODE_RELU
    b1 = ff.conv2d(t, 384, 3, 3, 2, 2, 0, 0, r, name=f"iB{i}_b1")
    b2 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, r, name=f"iB{i}_b2a")
    b2 = ff.conv2d(b2, 96, 3, 3, 1, 1, 1, 1, r, name=f"iB{i}_b2b")
    b2 = ff.conv2d(b2, 96, 3, 3, 2, 2, 0, 0, r, name=f"iB{i}_b2c")
    b3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"iB{i}_b3")
    return ff.concat([b1, b2, b3], axis=1, name=f"iB{i}_cat")


def _inception_c(ff, t, c, i):
    """7x7-factorized block (reference: inception.cc InceptionC)."""
    r = ActiMode.AC_MODE_RELU
    b1 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, r, name=f"iC{i}_b1")
    b2 = ff.conv2d(t, c, 1, 1, 1, 1, 0, 0, r, name=f"iC{i}_b2a")
    b2 = ff.conv2d(b2, c, 1, 7, 1, 1, 0, 3, r, name=f"iC{i}_b2b")
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0, r, name=f"iC{i}_b2c")
    b3 = ff.conv2d(t, c, 1, 1, 1, 1, 0, 0, r, name=f"iC{i}_b3a")
    b3 = ff.conv2d(b3, c, 7, 1, 1, 1, 3, 0, r, name=f"iC{i}_b3b")
    b3 = ff.conv2d(b3, c, 1, 7, 1, 1, 0, 3, r, name=f"iC{i}_b3c")
    b3 = ff.conv2d(b3, c, 7, 1, 1, 1, 3, 0, r, name=f"iC{i}_b3d")
    b3 = ff.conv2d(b3, 192, 1, 7, 1, 1, 0, 3, r, name=f"iC{i}_b3e")
    b4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"iC{i}_b4a")
    b4 = ff.conv2d(b4, 192, 1, 1, 1, 1, 0, 0, r, name=f"iC{i}_b4b")
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"iC{i}_cat")


def _inception_d(ff, t, i):
    """Grid reduction 17->8 (reference: inception.cc InceptionD)."""
    r = ActiMode.AC_MODE_RELU
    b1 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, r, name=f"iD{i}_b1a")
    b1 = ff.conv2d(b1, 320, 3, 3, 2, 2, 0, 0, r, name=f"iD{i}_b1b")
    b2 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, r, name=f"iD{i}_b2a")
    b2 = ff.conv2d(b2, 192, 1, 7, 1, 1, 0, 3, r, name=f"iD{i}_b2b")
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0, r, name=f"iD{i}_b2c")
    b2 = ff.conv2d(b2, 192, 3, 3, 2, 2, 0, 0, r, name=f"iD{i}_b2d")
    b3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name=f"iD{i}_b3")
    return ff.concat([b1, b2, b3], axis=1, name=f"iD{i}_cat")


def _inception_e(ff, t, i):
    """Expanded-filter-bank block, 6-way concat (reference: InceptionE)."""
    r = ActiMode.AC_MODE_RELU
    b1 = ff.conv2d(t, 320, 1, 1, 1, 1, 0, 0, r, name=f"iE{i}_b1")
    b2i = ff.conv2d(t, 384, 1, 1, 1, 1, 0, 0, r, name=f"iE{i}_b2i")
    b2 = ff.conv2d(b2i, 384, 1, 3, 1, 1, 0, 1, r, name=f"iE{i}_b2a")
    b3 = ff.conv2d(b2i, 384, 3, 1, 1, 1, 1, 0, r, name=f"iE{i}_b2b")
    b4i = ff.conv2d(t, 448, 1, 1, 1, 1, 0, 0, r, name=f"iE{i}_b4i")
    b4i = ff.conv2d(b4i, 384, 3, 3, 1, 1, 1, 1, r, name=f"iE{i}_b4m")
    b4 = ff.conv2d(b4i, 384, 1, 3, 1, 1, 0, 1, r, name=f"iE{i}_b4a")
    b5 = ff.conv2d(b4i, 384, 3, 1, 1, 1, 1, 0, r, name=f"iE{i}_b4b")
    b6 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"iE{i}_b6a")
    b6 = ff.conv2d(b6, 192, 1, 1, 1, 1, 0, 0, r, name=f"iE{i}_b6b")
    return ff.concat([b1, b2, b3, b4, b5, b6], axis=1, name=f"iE{i}_cat")


def inception_v3(ff, batch_size: int, num_classes: int = 10,
                 image_size: int = 299):
    """Full InceptionV3 tower (reference: inception.cc:150-174 — stem, 3xA,
    B, 4xC, D, 2xE, 8x8 avg-pool head). The branchy graph is the op-parallel
    search showcase."""
    r = ActiMode.AC_MODE_RELU
    x = ff.create_tensor([batch_size, 3, image_size, image_size], name="input")
    t = ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0, r, name="c1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, r, name="c2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, r, name="c3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="p1")
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, r, name="c4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, r, name="c5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="p2")
    t = _inception_a(ff, t, 32, 0)
    t = _inception_a(ff, t, 64, 1)
    t = _inception_a(ff, t, 64, 2)
    t = _inception_b(ff, t, 0)
    t = _inception_c(ff, t, 128, 0)
    t = _inception_c(ff, t, 160, 1)
    t = _inception_c(ff, t, 160, 2)
    t = _inception_c(ff, t, 192, 3)
    t = _inception_d(ff, t, 0)
    t = _inception_e(ff, t, 0)
    t = _inception_e(ff, t, 1)
    h = t.dims[2]
    t = ff.pool2d(t, h, h, 1, 1, 0, 0, PoolType.POOL_AVG, name="gap")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return x, t


def candle_uno(ff, batch_size: int,
               dense_layers=(1000, 1000, 1000),
               dense_feature_layers=(1000, 1000, 1000)):
    """CANDLE Uno drug-response MLP (reference: candle_uno.cc:29-126):
    7 inputs over 4 feature types, each through its own encoder tower (same
    structure, independent weights — matching the reference, which calls
    build_feature_model per input); encodings concat into a final MLP with
    scalar output. Returns (inputs dict, output tensor)."""
    feature_shapes = {"dose": 1, "cell.rnaseq": 942,
                      "drug.descriptors": 5270, "drug.fingerprints": 2048}
    input_features = {"dose1": "dose", "dose2": "dose",
                      "cell.rnaseq": "cell.rnaseq",
                      "drug1.descriptors": "drug.descriptors",
                      "drug1.fingerprints": "drug.fingerprints",
                      "drug2.descriptors": "drug.descriptors",
                      "drug2.fingerprints": "drug.fingerprints"}
    inputs = {}
    encoded = []
    for input_name, feat in input_features.items():
        safe = input_name.replace(".", "_")
        x = ff.create_tensor([batch_size, feature_shapes[feat]], name=safe)
        inputs[safe] = x
        t = x
        # per-feature-type encoder (towers share structure, not weights —
        # matching the reference, which builds a fresh build_feature_model
        # per input: candle_uno.cc:106-119)
        for li, width in enumerate(dense_feature_layers):
            t = ff.dense(t, width, ActiMode.AC_MODE_RELU,
                         name=f"{safe}_enc{li}")
        encoded.append(t)
    out = ff.concat(encoded, axis=1, name="cat")
    for li, width in enumerate(dense_layers):
        out = ff.dense(out, width, ActiMode.AC_MODE_RELU, name=f"mlp{li}")
    out = ff.dense(out, 1, name="out")
    return inputs, out


def inception_v3_stem(ff, batch_size: int, num_classes: int = 1000,
                      image_size: int = 299):
    """InceptionV3 stem + 3x InceptionA + head (abridged but faithfully
    branchy — the op-parallel benefit shows in the A-blocks; reference
    inception.cc builds the full tower the same way)."""
    x = ff.create_tensor([batch_size, 3, image_size, image_size],
                         name="input")
    t = ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0, ActiMode.AC_MODE_RELU, name="c1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, ActiMode.AC_MODE_RELU, name="c2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU, name="c3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="p1")
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_RELU, name="c4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 0, 0, ActiMode.AC_MODE_RELU, name="c5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="p2")
    t = _inception_a(ff, t, 32, 0)
    t = _inception_a(ff, t, 64, 1)
    t = _inception_a(ff, t, 64, 2)
    h = t.dims[2]
    t = ff.pool2d(t, h, h, 1, 1, 0, 0, PoolType.POOL_AVG, name="gap")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return x, t
