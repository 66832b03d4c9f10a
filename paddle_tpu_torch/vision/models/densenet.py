"""DenseNet family (DenseNet, densenet121/161/169/201/264) (counterpart of
``paddle_tpu/vision/models/densenet.py``), built from
``paddle_tpu_torch.nn``."""
from __future__ import annotations

from ... import nn, ops


class _DenseLayer(nn.Layer):
    def __init__(self, num_channels, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(num_channels)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_channels, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return ops.concat([x, out], axis=1)


class _DenseBlock(nn.Layer):
    def __init__(self, num_layers, num_channels, growth_rate, bn_size,
                 dropout):
        super().__init__()
        self.layers = nn.LayerList([
            _DenseLayer(num_channels + i * growth_rate, growth_rate, bn_size,
                        dropout) for i in range(num_layers)])

    def forward(self, x):
        for l in self.layers:
            x = l(x)
        return x


class _Transition(nn.Layer):
    def __init__(self, num_channels, num_out):
        super().__init__()
        self.bn = nn.BatchNorm2D(num_channels)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(num_channels, num_out, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        num_init, growth, block_cfg = _CFG[layers]
        self.stem = nn.Sequential(
            nn.Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
        blocks = []
        ch = num_init
        for i, n in enumerate(block_cfg):
            blocks.append(_DenseBlock(n, ch, growth, bn_size, dropout))
            ch += n * growth
            if i != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2))
                ch //= 2
        self.blocks = nn.Sequential(*blocks)
        self.bn_final = nn.BatchNorm2D(ch)
        self.relu_final = nn.ReLU()
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.relu_final(self.bn_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.classifier(x)
        return x


def _densenet(layers, pretrained=False, **kwargs):
    assert not pretrained, "pretrained weights are not bundled"
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
