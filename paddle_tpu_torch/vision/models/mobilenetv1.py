"""MobileNetV1 (counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``),
built from ``paddle_tpu_torch.nn``."""
from __future__ import annotations

from ... import nn, ops


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride,
                              padding=padding, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, scale):
        super().__init__()
        in_s, out_s = int(in_ch * scale), int(out_ch * scale)
        self.dw = _ConvBNRelu(in_s, in_s, 3, stride=stride, padding=1,
                              groups=in_s)
        self.pw = _ConvBNRelu(in_s, out_s, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # (in, out, stride)
            (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
            (256, 256, 1), (256, 512, 2),
            (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
            (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
        ]
        layers = [_ConvBNRelu(3, int(32 * scale), 3, stride=2, padding=1)]
        for i, (cin, cout, s) in enumerate(cfg):
            layers.append(_DepthwiseSeparable(cin, cout, s, scale))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    assert not pretrained
    return MobileNetV1(scale=scale, **kwargs)
