"""The paper's own model: AlexNet on PlantVillage-38 (paper §4.1)."""
from repro_torch.models.cnn import alexnet_config, tiny_cnn_config

CONFIG = alexnet_config(num_classes=38)


def smoke_config():
    return tiny_cnn_config(num_classes=38, width=0.25, hw=64)
