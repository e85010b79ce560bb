"""Architecture registry: --arch <id> resolution."""
from repro_torch.configs.base import ArchConfig

from repro_torch.configs.phi4_mini_3p8b import CONFIG as _phi4
from repro_torch.configs.deepseek_coder_33b import CONFIG as _dsc
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.starcoder2_7b import CONFIG as _sc2
from repro_torch.configs.internvl2_76b import CONFIG as _ivl
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moon
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (_phi4, _dsc, _gemma, _sc2, _ivl, _whisper, _moon, _mixtral, _rg, _rwkv)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)
