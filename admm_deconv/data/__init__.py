"""Data pipeline: paired-image dataset, loaders, dataset synthesis."""

from admm_deconv.data.imageio import load_image, save_image, img_to_tensor, tensor_to_img
from admm_deconv.data.feeder import ImageDataFeeder, DataLoader
from admm_deconv.data.dataset import (
    add_awgn,
    add_poisson_gaussian,
    generate_awgn_dataset,
    generate_awgn_splits,
)

__all__ = [
    "load_image",
    "save_image",
    "img_to_tensor",
    "tensor_to_img",
    "ImageDataFeeder",
    "DataLoader",
    "add_awgn",
    "add_poisson_gaussian",
    "generate_awgn_dataset",
    "generate_awgn_splits",
]
