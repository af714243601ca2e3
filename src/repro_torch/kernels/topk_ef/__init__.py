from repro_torch.kernels.topk_ef.ops import topk_ef  # noqa: F401
