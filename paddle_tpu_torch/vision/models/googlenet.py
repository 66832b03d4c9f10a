"""GoogLeNet / InceptionV1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``), built from
``paddle_tpu_torch.nn``."""
from __future__ import annotations

from ... import nn, ops


class _ConvBN(nn.Layer):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_ch, c1, 1)
        self.b2 = nn.Sequential(_ConvBN(in_ch, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_ConvBN(in_ch, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _ConvBN(in_ch, proj, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                          axis=1)


class _AuxHead(nn.Layer):
    """Aux classifier branch (googlenet.py out1/out2)."""

    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _ConvBN(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(ops.flatten(x, 1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(nn.Layer):
    """Returns (out, aux1, aux2) like the reference (googlenet.py forward);
    aux heads hang off inception 4a and 4d."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, padding=1),
            _ConvBN(64, 64, 1), _ConvBN(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.inc3 = nn.Sequential(
            _Inception(192, 64, 96, 128, 16, 32, 32),
            _Inception(256, 128, 128, 192, 32, 96, 64),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4bcd = nn.Sequential(
            _Inception(512, 160, 112, 224, 24, 64, 64),
            _Inception(512, 128, 128, 256, 24, 64, 64),
            _Inception(512, 112, 144, 288, 32, 64, 64))
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.inc5 = nn.Sequential(
            _Inception(832, 256, 160, 320, 32, 128, 128),
            _Inception(832, 384, 192, 384, 48, 128, 128))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.inc3(self.stem(x))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4bcd(x)
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.fc(self.dropout(x))
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    assert not pretrained
    return GoogLeNet(**kwargs)
