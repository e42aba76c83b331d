from .federated import partition_iid, sample_indices
from .synthetic import mnist_like
