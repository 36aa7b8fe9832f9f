"""Config registry: ``get_arch(name)`` / ``ARCHS`` / ``SHAPES`` (the port's
copies of the JAX package's configs)."""

from repro_torch.configs.base import ArchConfig, NomadConfig, ShapeConfig, SHAPES, reduced
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3
from repro_torch.configs.minitron_4b import CONFIG as MINITRON
from repro_torch.configs.yi_34b import CONFIG as YI34B
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT
from repro_torch.configs.internvl2_76b import CONFIG as INTERNVL2
from repro_torch.configs.nomad_workloads import (
    NOMAD_WORKLOADS,
    PIPELINE_WORKLOADS,
    PipelineWorkload,
    QUICKSTART,
    PUBMED,
    WIKI60M,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        LLAMA4_SCOUT,
        MIXTRAL,
        JAMBA,
        MAMBA2,
        PHI4,
        QWEN3,
        MINITRON,
        YI34B,
        HUBERT,
        INTERNVL2,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_nomad(name: str) -> NomadConfig:
    if name not in NOMAD_WORKLOADS:
        raise KeyError(f"unknown NOMAD workload {name!r}; available: {sorted(NOMAD_WORKLOADS)}")
    return NOMAD_WORKLOADS[name]


__all__ = [
    "ArchConfig",
    "NomadConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCHS",
    "NOMAD_WORKLOADS",
    "PIPELINE_WORKLOADS",
    "PipelineWorkload",
    "get_arch",
    "get_nomad",
    "reduced",
    "QUICKSTART",
    "PUBMED",
    "WIKI60M",
]
