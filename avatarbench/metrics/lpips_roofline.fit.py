"""The LPIPS trunk's share of its roofline in the fit's traced window: the
least time its convolutions need at the fp32 peak
(``roofline_fit.lpips_bound``: VGG16's forward FLOPs on every image the
program's counters report, and the input gradient of the predicted half)
over the summed device time of the kernels its convolutions launch: on
one H100 with PyTorch 2.11 and TF32 off, cuDNN's forward implicit GEMMs
(``sm80_xmma_fprop_implicit_gemm_f32f32_..._cudnn``), its direct kernel
for the 3-channel first layer (``convolve_common_engine_float_NHWC``), its
input-gradient kernels (``cudnn::detail::dgrad_engine``) and the layout
transforms and scalings around them (``cudnn::engines_precompiled::*``);
nothing else in the fit step calls cuDNN."""
from avatarbench import roofline_fit

KERNELS = r"(cudnn|\bconvolve_common_engine)"


def read(run):
    counts = getattr(run, "counters", {}).get("lpips")
    if run.trace is None or not counts or not counts[1]:
        return None
    seconds = run.trace.kernel_s(KERNELS)
    if not seconds:
        return None
    S = run.tr["patch_size"]
    return 100.0 * roofline_fit.lpips_bound(counts[1], S, S) / seconds
