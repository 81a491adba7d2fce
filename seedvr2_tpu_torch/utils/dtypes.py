"""Dtype policy: bf16 compute with fp32 islands (RoPE, softmax statistics,
normalization statistics, colour math), as in seedvr2_tpu.utils.dtypes."""

import torch

# Unified compute dtype across the pipeline.
COMPUTE_DTYPE = torch.bfloat16

# Accumulation / sensitive-math dtype.
ACCUM_DTYPE = torch.float32
