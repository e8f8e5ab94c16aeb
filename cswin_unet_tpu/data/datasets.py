"""Dataset readers for the Synapse/KiTS23/LiTS17 slice+volume layout.

File-format parity with the reference ``Synapse_dataset``
(``datasets/dataset_synapse.py:50-83``):

  * train split: one ``<case>.npz`` per 2D slice with keys ``image`` +
    ``label`` (or ``segmentation``), names from ``<list_dir>/train.txt``;
  * test split: one ``<case>.npy.h5`` 3D volume per case with keys
    ``image``/``label`` (or ``images``/``segmentations``), names from
    ``<list_dir>/test_vol.txt``.
"""

from __future__ import annotations

import os

import numpy as np


class SynapseDataset:
    def __init__(self, base_dir: str, list_dir: str, split: str, transform=None):
        self.transform = transform
        self.split = split
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [l.strip() for l in f.readlines() if l.strip()]
        self.data_dir = base_dir

    def __len__(self) -> int:
        return len(self.sample_list)

    def case_name(self, idx: int) -> str:
        return self.sample_list[idx]

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        name = self.sample_list[idx]
        if self.split == "train":
            data = np.load(os.path.join(self.data_dir, name + ".npz"))
            image = data["image"]
            label = data["label"] if "label" in data else data["segmentation"]
        else:
            import h5py  # only the .npy.h5 volume format needs it

            path = os.path.join(self.data_dir, f"{name}.npy.h5")
            with h5py.File(path, "r") as data:
                if "label" in data:
                    image, label = data["image"][:], data["label"][:]
                else:
                    image, label = data["images"][:], data["segmentations"][:]

        sample = {"image": image, "label": label, "case_name": name}
        if self.transform is not None:
            sample = self.transform(sample, rng if rng is not None else np.random.default_rng())
        return sample


class Subset:
    """Index-subset view of a dataset (torch.utils.data.Subset equivalent)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx, rng=None):
        return self.dataset.__getitem__(self.indices[idx], rng)
