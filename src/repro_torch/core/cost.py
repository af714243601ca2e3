"""Cloud pricing + hardware constants for the FaaS/IaaS emulation.

Prices are the paper-era (2020/21) us-east-1 list prices the paper used.
Compute throughput constants are calibrated so C^F ~= C^I per core, matching
the paper's observation that Lambda and EC2 data loading + computation take
similar time per row (Fig 10).
"""
from __future__ import annotations

# ---- $ pricing ---------------------------------------------------------------
LAMBDA_GB_S = 1.66667e-5          # $ per GB-second
LAMBDA_REQUEST = 2e-7             # $ per invocation
EC2_HOURLY = {
    "t2.medium": 0.0464,
    "t2.2xlarge": 0.3712,
    "c5.large": 0.085,
    "c5.xlarge": 0.17,
    "c5.4xlarge": 0.68,
    "g3s.xlarge": 0.75,           # NVIDIA M60
    "g4dn.xlarge": 0.526,         # NVIDIA T4
    "m5a.12xlarge": 2.064,
}
ELASTICACHE_HOURLY = {
    "cache.t3.small": 0.034,
    "cache.t3.medium": 0.068,
    "cache.m5.large": 0.156,
}
DYNAMODB_PER_MREQ = 1.25          # $ per million write request units (on-demand)
SPOT_DISCOUNT = 0.3               # spot price as a fraction of on-demand
                                  # (paper-era us-east-1 averages ~65-75% off)
S3_PUT = 5e-6                     # $ per PUT
S3_GET = 4e-7                     # $ per GET

# ---- compute-throughput model -------------------------------------------------
# effective f32 GFLOP/s per worker for the study models (dense matvec-bound)
LAMBDA_3GB_FLOPS = 5e9            # 1.8 vCPU
LAMBDA_1GB_FLOPS = 1.7e9          # 0.6 vCPU
VM_CPU_FLOPS = 5.5e9              # t2.medium (2 vCPU, one training proc)
VM_GPU_FLOPS = {"g3s.xlarge": 150e9, "g4dn.xlarge": 300e9}  # NN models only
VM_GPU_FLOPS_DEFAULT = VM_GPU_FLOPS["g3s.xlarge"]  # unknown-GPU fallback

# ---- serving memory model (DESIGN.md §14) ------------------------------------
# Replica RAM bounds model weights + KV cache; memory bandwidth sets the
# weight-streaming floor of a decode step (the roofline's second leg).
LAMBDA_MEM_BW = 10e9              # bytes/s, Lambda sandbox DDR share
VM_MEM_BW = 12e9                  # bytes/s, t2/c5-class DDR4
VM_GPU_MEM_BW = {"g3s.xlarge": 160e9, "g4dn.xlarge": 320e9}   # HBM/GDDR
VM_GPU_MEM_BW_DEFAULT = VM_GPU_MEM_BW["g4dn.xlarge"]  # unknown-GPU fallback
EC2_RAM_GB = {
    "t2.medium": 4.0, "t2.2xlarge": 32.0,
    "c5.large": 4.0, "c5.xlarge": 8.0, "c5.4xlarge": 32.0,
    "g3s.xlarge": 30.5, "g4dn.xlarge": 16.0, "m5a.12xlarge": 192.0,
}
GPU_HBM_GB = {"g3s.xlarge": 8.0, "g4dn.xlarge": 16.0}

# ---- accelerator pods (the third infrastructure, DESIGN.md §11) --------------
TPU_CHIP_HOURLY = 1.2             # $ per v5e chip-hour, on-demand list price
POD_HBM_GB = 16.0                 # HBM per v5e chip
#: peak bf16 FLOP/s of one simulated pod chip (v5e), the input the pod
#: platform discounts by its MFU -- a constant of the SIMULATED fleet, copied
#: from the JAX package's roofline model, and no statement about the speed
#: of the card this port runs on
PEAK_FLOPS = 197e12
#: HBM bytes/s of one simulated pod chip (v5e), the weight-streaming floor
#: of the pod platform's serving replicas -- likewise a constant of the
#: SIMULATED fleet, copied from the JAX package's roofline model
HBM_BW = 819e9


def lambda_cost(gb: float, seconds: float, invocations: int = 1) -> float:
    return gb * seconds * LAMBDA_GB_S + invocations * LAMBDA_REQUEST


def ec2_cost(instance: str, seconds: float, count: int = 1) -> float:
    return EC2_HOURLY[instance] / 3600.0 * seconds * count
