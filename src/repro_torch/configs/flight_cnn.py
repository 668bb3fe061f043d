"""The paper's own Tier-A workloads: small CNN classifiers federated over
heterogeneous workers (MNIST / CIFAR-10 experiments, Figs. 12-18)."""
from repro_torch.models.config import ModelConfig

CONFIG_MNIST = ModelConfig(
    name="flight-cnn-mnist", family="cnn",
    num_layers=2, d_model=0,
    img_hw=28, img_c=1, cnn_channels=(16, 32), n_classes=10,
    remat=False,
)

CONFIG_CIFAR = ModelConfig(
    name="flight-cnn-cifar", family="cnn",
    num_layers=2, d_model=0,
    img_hw=32, img_c=3, cnn_channels=(32, 64), n_classes=10,
    remat=False,
)
