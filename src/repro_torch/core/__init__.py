from repro_torch.core.cauchy import cauchy, cauchy_pairwise

__all__ = ["cauchy", "cauchy_pairwise"]
