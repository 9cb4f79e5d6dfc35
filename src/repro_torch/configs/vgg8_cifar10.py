"""VGG-8 on (synthetic-)CIFAR-10: the paper's own accuracy-experiment
model (Fig. 10)."""
from repro_torch.models.vgg import Vgg8Config


def config() -> Vgg8Config:
    return Vgg8Config(n_classes=10, image_size=32, fc_dim=1024)
