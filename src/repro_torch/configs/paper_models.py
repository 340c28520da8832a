"""The paper's own experiment models (Sec. VI-A).

CNN classifiers used in Tables II-V / Figs 3-4:
  * F-MNIST : 2 conv layers (16, 32 ch) + 2x2 maxpool + ReLU  [McMahan '17]
  * CIFAR-10: VGG11-style conv stack                          [Simonyan '15]
  * KWS     : 3 conv layers (16, 32, 64 ch) + 256-unit FC on 50x16 MFCCs

A copy of ``repro.configs.paper_models`` (the port imports nothing of the
reference package).
"""
import dataclasses
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_shape: tuple          # (H, W, C)
    num_classes: int
    conv_channels: Sequence[int]
    fc_units: Sequence[int]
    pool: tuple = (2, 2)
    dataset: str = "fmnist"

    def binary(self) -> "CNNConfig":
        """FedOVA component classifier: same body, 1-logit head."""
        return dataclasses.replace(self, num_classes=1)


FMNIST_CNN = CNNConfig(
    name="fmnist_cnn", input_shape=(28, 28, 1), num_classes=10,
    conv_channels=(16, 32), fc_units=(128,), dataset="fmnist",
)

CIFAR_VGG = CNNConfig(
    name="cifar_vgg11", input_shape=(32, 32, 3), num_classes=10,
    conv_channels=(64, 128, 256, 256, 512, 512, 512, 512),
    fc_units=(512,), dataset="cifar10",
)

KWS_CNN = CNNConfig(
    name="kws_cnn", input_shape=(50, 16, 1), num_classes=10,
    conv_channels=(16, 32, 64), fc_units=(256,), pool=(1, 2), dataset="kws",
)

CNN_CONFIGS = {c.name: c for c in (FMNIST_CNN, CIFAR_VGG, KWS_CNN)}


def reduced(cfg: CNNConfig) -> CNNConfig:
    return dataclasses.replace(
        cfg, conv_channels=tuple(min(c, 16) for c in cfg.conv_channels[:2]),
        fc_units=(32,),
    )
