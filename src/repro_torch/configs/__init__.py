from repro_torch.configs.base import NomadConfig
from repro_torch.configs.nomad_workloads import PUBMED, QUICKSTART

__all__ = ["NomadConfig", "PUBMED", "QUICKSTART"]
