from repro_torch.data.synthetic import gaussian_mixture

__all__ = ["gaussian_mixture"]
