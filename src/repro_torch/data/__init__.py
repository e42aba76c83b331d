from .federated import partition_iid, round_batches, sample_indices
from .synthetic import lm_batch, mnist_like, token_batches, uniform_lm_batch
