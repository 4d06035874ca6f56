"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the rates a roofline share or an MFU is taken against.
A card set below 700 W (``nvidia-smi``'s ``power.limit``, printed with
every run) reaches less."""

FLOPS = {
    "fp8": 1979e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,      # the tensor cores' rate on float32 inputs
    "float32": 67e12,    # the CUDA cores, outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
