"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``),
built from ``paddle_tpu_torch.nn``."""
from __future__ import annotations

from ... import nn, ops


def _channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = ops.reshape(x, [b, groups, c // groups, h, w])
    x = ops.transpose(x, [0, 2, 1, 3, 4])
    return ops.reshape(x, [b, c, h, w])


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_ch, out_ch, stride):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        if stride == 1:
            assert in_ch == out_ch
            self.branch2 = nn.Sequential(
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU(),
                nn.Conv2D(branch, branch, 3, stride=1, padding=1,
                          groups=branch, bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU())
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=2, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU())
            self.branch2 = nn.Sequential(
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU(),
                nn.Conv2D(branch, branch, 3, stride=2, padding=1,
                          groups=branch, bias_attr=False),
                nn.BatchNorm2D(branch),
                nn.Conv2D(branch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU())

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = ops.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = ops.concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        out = _STAGE_OUT[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, out[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(out[0]), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_ch = out[0]
        for i, repeats in enumerate([4, 8, 4]):
            oc = out[i + 1]
            units = [_ShuffleUnit(in_ch, oc, 2)]
            units += [_ShuffleUnit(oc, oc, 1) for _ in range(repeats - 1)]
            stages.append(nn.Sequential(*units))
            in_ch = oc
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, out[4], 1, bias_attr=False),
            nn.BatchNorm2D(out[4]), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(out[4], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    assert not pretrained
    return ShuffleNetV2(scale=2.0, **kwargs)
