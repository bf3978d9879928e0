"""Device milliseconds a traced training step of cuDNN's RNN kernels, forward and backward of the three bidirectional layers (``models.vgsl.VGSLModel``'s ``torch.nn.LSTM``), found by the names the card's trace gives them (``KERNELS``). The layers' input projections and weight gradients are whole-sequence products whose kernels (``sm80_xmma_gemm_*``, cutlass ``sgemm``) the head's share, so they are left out."""

# substrings of the kernels an H100's trace of this cell shows for cuDNN's
# LSTM (cuDNN 9.22, torch 2.11): its cells elemWiseRNNcell<float, ...,
# (cudnnRNNMode_t)2, ...>, LSTM_elementWise_bp1<float, ...>(...,
# cudnnRNNClipMode_t, ...) and GENERIC_elementWise_bp2<..., (cudnnRNNBiasMode_t)2>
# (each name holds "RNN"), and the recurrent products it launches a frame
# through cuBLAS's batched GEMV, gemmSN_NN_kernel / gemmSN_TN_kernel<float,
# ..., cublasGemvTensorStridedBatched<...>>, which nothing else in a step
# launches
KERNELS = ("RNN", "gemmSN_")


def read(ctx):
    hits = [e - s for name, s, e in ctx.dev
            if any(k in name for k in KERNELS)]
    if not hits or not ctx.traced:
        return None
    return sum(hits) * 1e-3 / len(ctx.traced)
