"""Operations on NCHW tensors; the StyleGAN2 hot ops launch the hand-written kernels on a CUDA device."""
