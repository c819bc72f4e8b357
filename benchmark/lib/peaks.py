"""Published peaks of the card the benchmark measures.

NVIDIA H100 SXM5 80 GB (NVIDIA's H100 Tensor Core GPU data sheet;
dense rates, no sparsity), at its full power limit of 700 W. A card set
below that limit runs slower under load; the run reports its limit.
The data sheet gives no rate for 32-bit integer operations: the
float32 rate outside the tensor cores bounds them (Hopper runs
integer operations at half of it), so a share against it is never
overstated.
"""

H100_SXM = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_w": 700.0,
    "hbm_bytes_per_s": 3.35e12,
    "alu32_ops_per_s": 67e12,
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
}
