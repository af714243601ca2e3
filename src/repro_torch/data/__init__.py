"""Data pipeline: the paper-study synthetic datasets (numpy, byte-identical
to the JAX package's for the same seed)."""
from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS, Dataset, make_dataset, partition, train_val_split,
)
