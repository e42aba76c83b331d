"""Plain PyTorch references of the benchmark's models and of the GenQSGD
round.  They import nothing of the port: the benchmark hands them the same
inputs it hands the program (weights, tokens, frames, key words, γ) and
they work out everything else again."""
