"""SSD single-shot detectors, the port of the JAX package's
models/ssd.py (reference: layers/detection.py multi_box_head / ssd_loss;
PaddleCV SSD on the Fluid 1.4 API).

``get_model``: a small conv + BN backbone with two detection feature
maps, the multi-box head, the fused ``ssd_loss`` and the NMS'd
``detection_output``. ``get_ssd300_model``: VGG16-SSD300 (six maps, 8732
priors). Ground truth arrives densely padded: gt_box [N, G, 4] xyxy
normalized to [0, 1] with zero-area padding rows, gt_label [N, G] int64.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.layers import detection


def _block(x, filters, stride, is_test):
    c = layers.conv2d(x, filters, 3, stride=stride, padding=1,
                      bias_attr=False)
    return layers.batch_norm(c, act="relu", is_test=is_test)


def ssd_net(img, image_shape=(3, 64, 64), num_classes=7, gt_capacity=8,
            is_test=False):
    """Build the detector. Returns dict with feeds + loss + heads."""
    x = _block(img, 16, 2, is_test)      # 32x32
    x = _block(x, 32, 2, is_test)        # 16x16
    f1 = _block(x, 32, 1, is_test)       # 16x16 feature map
    f2 = _block(f1, 64, 2, is_test)      # 8x8 feature map
    locs, confs, boxes, variances = detection.multi_box_head(
        [f1, f2], img, base_size=image_shape[-1],
        num_classes=num_classes,
        aspect_ratios=[[1.0, 2.0], [1.0, 2.0]],
        min_sizes=[image_shape[-1] * 0.2, image_shape[-1] * 0.5],
        max_sizes=[image_shape[-1] * 0.5, image_shape[-1] * 0.9],
        flip=True, clip=True)
    return locs, confs, boxes, variances


def get_model(batch_size=8, image_shape=(3, 64, 64), num_classes=7,
              gt_capacity=8, is_test=False):
    img = layers.data("image", shape=list(image_shape), dtype="float32")
    gt_box = layers.data("gt_box", shape=[gt_capacity, 4], dtype="float32")
    gt_label = layers.data("gt_label", shape=[gt_capacity], dtype="int64")
    locs, confs, boxes, variances = ssd_net(
        img, image_shape, num_classes, gt_capacity, is_test)
    # priors are normalized [0,1]; gt likewise
    loss = detection.ssd_loss(locs, confs, gt_box, gt_label, boxes,
                              variances)
    loss = layers.mean(loss)
    nmsed = detection.detection_output(
        locs, layers.softmax(confs), boxes, variances,
        keep_top_k=16, nms_top_k=32)
    return {
        "feeds": [img, gt_box, gt_label],
        "loss": loss,
        "locs": locs,
        "confs": confs,
        "detection": nmsed,
    }


def synthetic_batch(batch_size=8, image_shape=(3, 64, 64), num_classes=7,
                    gt_capacity=8, seed=0):
    """One synthetic batch: images with bright rectangles whose position
    defines the label (learnable signal), plus dense gt boxes."""
    r = np.random.RandomState(seed)
    imgs = r.normal(0, 0.1, (batch_size,) + tuple(image_shape)).astype(
        np.float32)
    boxes = np.zeros((batch_size, gt_capacity, 4), np.float32)
    labels = np.zeros((batch_size, gt_capacity), np.int64)
    for i in range(batch_size):
        n_obj = r.randint(1, 3)
        for j in range(n_obj):
            cx, cy = r.uniform(0.25, 0.75, 2)
            w, h = r.uniform(0.2, 0.4, 2)
            x1, y1 = max(cx - w / 2, 0.0), max(cy - h / 2, 0.0)
            x2, y2 = min(cx + w / 2, 1.0), min(cy + h / 2, 1.0)
            boxes[i, j] = [x1, y1, x2, y2]
            labels[i, j] = 1 + r.randint(num_classes - 1)
            hh, ww = image_shape[1], image_shape[2]
            imgs[i, :, int(y1 * hh):int(y2 * hh),
                 int(x1 * ww):int(x2 * ww)] += labels[i, j] / num_classes
    return {"image": imgs, "gt_box": boxes, "gt_label": labels}


# --------------------------------------------------------------------------
# SSD-300 (real scale): VGG16 backbone, 6 feature maps, 8732 priors
# (reference architecture: Liu et al. 2016; reference API surface:
# layers/detection.py multi_box_head/ssd_loss)
# --------------------------------------------------------------------------


def _vgg_block(x, filters, n, prefix):
    for i in range(n):
        x = layers.conv2d(x, filters, 3, padding=1, act="relu",
                          name=f"{prefix}_{i}")
    return x


def ssd300_net(img, num_classes=21):
    """VGG16-SSD300: maps at 38/19/10/5/3/1 -> 8732 priors."""
    x = _vgg_block(img, 64, 2, "conv1")
    x = layers.pool2d(x, 2, "max", 2)
    x = _vgg_block(x, 128, 2, "conv2")
    x = layers.pool2d(x, 2, "max", 2)
    x = _vgg_block(x, 256, 3, "conv3")
    x = layers.pool2d(x, 2, "max", 2, pool_padding=1)   # ceil: 38
    conv4 = _vgg_block(x, 512, 3, "conv4")              # 38x38
    x = layers.pool2d(conv4, 2, "max", 2)
    x = _vgg_block(x, 512, 3, "conv5")
    x = layers.pool2d(x, 3, "max", 1, pool_padding=1)
    x = layers.conv2d(x, 1024, 3, padding=6, dilation=6, act="relu",
                      name="fc6")                       # 19x19
    fc7 = layers.conv2d(x, 1024, 1, act="relu", name="fc7")
    x = layers.conv2d(fc7, 256, 1, act="relu", name="conv8_1")
    conv8 = layers.conv2d(x, 512, 3, stride=2, padding=1, act="relu",
                          name="conv8_2")               # 10x10
    x = layers.conv2d(conv8, 128, 1, act="relu", name="conv9_1")
    conv9 = layers.conv2d(x, 256, 3, stride=2, padding=1, act="relu",
                          name="conv9_2")               # 5x5
    x = layers.conv2d(conv9, 128, 1, act="relu", name="conv10_1")
    conv10 = layers.conv2d(x, 256, 3, act="relu", name="conv10_2")  # 3x3
    x = layers.conv2d(conv10, 128, 1, act="relu", name="conv11_1")
    conv11 = layers.conv2d(x, 256, 3, act="relu", name="conv11_2")  # 1x1

    maps = [conv4, fc7, conv8, conv9, conv10, conv11]
    return detection.multi_box_head(
        maps, img, base_size=300, num_classes=num_classes,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                       [2.0], [2.0]],
        min_sizes=[30.0, 60.0, 111.0, 162.0, 213.0, 264.0],
        max_sizes=[60.0, 111.0, 162.0, 213.0, 264.0, 315.0],
        steps=[8.0, 16.0, 32.0, 64.0, 100.0, 300.0],
        flip=True, clip=False)


def get_ssd300_model(num_classes=21, gt_capacity=50):
    """Real-scale SSD-300 training graph (8732 priors, VOC-sized class
    count, 50-row dense-padded gt)."""
    img = layers.data("image", shape=[3, 300, 300], dtype="float32")
    gt_box = layers.data("gt_box", shape=[gt_capacity, 4], dtype="float32")
    gt_label = layers.data("gt_label", shape=[gt_capacity], dtype="int64")
    locs, confs, boxes, variances = ssd300_net(img, num_classes)
    loss = layers.mean(detection.ssd_loss(
        locs, confs, gt_box, gt_label, boxes, variances))
    return {"feeds": [img, gt_box, gt_label], "loss": loss,
            "locs": locs, "confs": confs, "priors": boxes}
