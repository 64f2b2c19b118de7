"""The height split (`e4s2024_torch/parallel/spatial.py`, the `sp` axis of
the trainer's `(dp, sp)` grid) on two spawned CPU ranks over gloo: each
partitioned op and net, run on its rank's slab of rows, against the same
op run whole on the same numpy-seeded tensors (`tests/torch_ranks.py::
split_ops_cases`). Each case compares this rank's rows of the output, of
the input gradient (for the second-derivative cases, the gradient in the
output weights: the backward differentiated in its incoming gradient, as
R1 differentiates K1's and K2's backwards) and the parameter gradients
summed over the ranks.

The cases: the 3x3, strided and 1x1 strided convolutions; the transposed
convolution with its blur; the regional modulated convolutions, exact and
fast, with and without upsampling; upfirdn2d up, down and with uneven
pads; the blurred stride-2 ConvLayer; nearest and bilinear resizes at
integer, non-integer and 4:1 (1024 -> 256) ratios; InstanceNorm and the
masked average pool; a max pool and AlexNet's first layers, whose output
rows split unevenly (15 rows give 8 and 7); the Generator (exact and
fast), the Discriminator and its R1, the encoder, multiscale LPIPS and
the reconstruction criterion (LPIPS, ArcFace on the gathered crop, the
parsing U-Net at a quarter of its width on the gathered 512^2 image, L2).
The loss nets are held against JAX by tests/test_torch_criterion.py.
"""

import pytest
import torch

from tests.torch_ranks import sp_ops, start_ranks

CASES = ("conv3x3", "conv5x5_far_halo", "conv3x3_stride2", "conv1x1_stride2",
         "transposed_conv_blur", "regional_exact", "regional_exact_up", "regional_fast",
         "regional_fast_up", "upfirdn_up", "upfirdn_down", "upfirdn_blur_pads_2_1",
         "blur_conv_stride2", "nearest_down", "nearest_up", "nearest_16_to_6",
         "bilinear_1024_to_256_ratio", "bilinear_up", "instance_norm", "masked_average_pool",
         "max_pool_uneven", "alexnet_uneven_rows", "generator_exact", "generator_fast",
         "discriminator", "discriminator_r1", "encoder", "lpips_multiscale",
         "recon_criterion")

# float32 summation order alone: a split sums a mean, a norm or a
# parameter's gradient in two halves and then adds them, and runs its
# convolutions on windows, whose shapes take other blockings (readings on
# an 8-core CPU: 5.6e-6 of the encoder's parameter gradients alone; under the
# load of other test processes 1.6e-5 of AlexNet's first layers and 3.0e-5
# of LPIPS's input gradient). A missing or misplaced halo row moves an
# output by the order of its own magnitude.
FWD_REL = GRAD_REL = PARAMS_REL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield start_ranks(sp_ops, {"names": CASES}, tmp_path_factory.mktemp("sp_ops")).join()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", CASES)
def test_split_op_matches_the_whole_op(ranks, name):
    for rank, results in enumerate(ranks):
        res = results[name]
        for part, rel in (("fwd", FWD_REL), ("grad", GRAD_REL), ("params", PARAMS_REL)):
            err, scale = res[part]
            assert err <= rel * max(scale, 1e-12), (rank, name, part, err, scale)
