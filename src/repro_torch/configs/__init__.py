"""Architecture registry: ``get_spec("--arch id")`` for every assigned arch."""
from . import (arctic_480b, command_r_plus_104b, dien, dlrm_rm2, favor_anns,
               fm, gcn_cora, gemma2_2b, olmoe_1b_7b, qwen15_32b, wide_deep)
from .base import ArchSpec, ShapeCell

_MODULES = {
    "olmoe-1b-7b": olmoe_1b_7b,
    "arctic-480b": arctic_480b,
    "qwen1.5-32b": qwen15_32b,
    "command-r-plus-104b": command_r_plus_104b,
    "gemma2-2b": gemma2_2b,
    "gcn-cora": gcn_cora,
    "fm": fm,
    "wide-deep": wide_deep,
    "dien": dien,
    "dlrm-rm2": dlrm_rm2,
    "favor-anns": favor_anns,
}

ASSIGNED = [k for k in _MODULES if k != "favor-anns"]


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {list(_MODULES)}")
    return _MODULES[arch_id].spec()


def all_specs(include_favor: bool = True):
    ids = list(_MODULES) if include_favor else ASSIGNED
    return {a: get_spec(a) for a in ids}
