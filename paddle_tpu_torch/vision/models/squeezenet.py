"""SqueezeNet (counterpart of ``paddle_tpu/vision/models/squeezenet.py``),
built from ``paddle_tpu_torch.nn``."""
from __future__ import annotations

from ... import nn, ops


class _Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return ops.concat([self.relu(self.expand1(x)),
                           self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        if num_classes > 0:
            # convs separate from pooling: with_pool=False keeps the spatial
            # class map (reference fully-convolutional use)
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.relu_feat = nn.ReLU()

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
            if self.with_pool:
                x = self.pool(x)
                x = ops.flatten(x, 1)           # [B, num_classes]
            return x                            # else [B, C, H, W]
        if self.with_pool:
            # feature extractor (reference forward): relu → pool → [B, 512]
            x = self.pool(self.relu_feat(x))
            x = ops.squeeze(x, axis=[2, 3])
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    assert not pretrained
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    assert not pretrained
    return SqueezeNet("1.1", **kwargs)
