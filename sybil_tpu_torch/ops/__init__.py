"""Device kernels: hand-written CUDA for Hopper (csrc/) behind PyTorch
wrappers, each with a plain PyTorch version beside it for CPU tensors."""
