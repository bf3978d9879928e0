"""Share of its roofline of the conv front end of kraken's network under training (``models.vgsl.conv_features`` on cuDNN, float32, TF32 off: the forward, the input gradient of convolutions 2-4 and the weight gradient of all four) over the traced steps: the least time of that work (``work/vgsl_train.py``) over the device time of cuDNN's forward, data-gradient and weight-gradient convolution kernels, found by the names the card's trace gives them (``KERNELS``)."""

# substrings of the convolution kernels an H100's trace of this cell shows
# (cuDNN 9.22): forward implicit_convolve_sgemm<float, ...> and
# sm80_xmma_fprop_implicit_gemm_f32f32_..._cudnn; input gradient
# sm80_xmma_dgrad_implicit_gemm_f32f32_..._cudnn and, where cuDNN takes
# the FFT route, fft2d_r2c_32x32 / fft2d_c2r_32x32 with their complex
# product sm80_xmma_gemm_cf32cf32_..._cublas; weight gradient
# wgrad_alg0_engine<float, ...> (cuDNN picks by shape: its other float32
# routes name themselves by the rest)
KERNELS = ("convolve", "fprop", "dgrad", "wgrad", "fft2d", "gemm_cf32",
           "winograd")


def read(ctx):
    least = ctx.work.least_seconds("vgsl_conv_train")
    hits = [e - s for name, s, e in ctx.dev
            if any(k in name for k in KERNELS)]
    if least is None or not hits or sum(hits) <= 0:
        return None
    return 100.0 * least / (sum(hits) * 1e-6)
