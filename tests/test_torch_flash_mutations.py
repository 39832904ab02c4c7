"""tools/flash_mutation_check.py must keep quoting the current kernels.

Each mutation of that tool replaces one text of a CUDA source in
horovod_tpu_torch/ops/csrc; the tool refuses to run when the text is not
there exactly once.  These tests hold every text against the sources on
the CPU, so an edit to a kernel that leaves a mutation behind fails
here rather than on the card.  Neither jax nor horovod_tpu is imported.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "flash_mutation_check.py"


def _tool():
    spec = importlib.util.spec_from_file_location("flash_mutation_check",
                                                  TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_TOOL = _tool()
MUTATIONS = _TOOL.MUTATIONS
CSRC = ROOT / _TOOL.CSRC


@pytest.mark.parametrize("name", sorted(n for n, m in MUTATIONS.items()
                                        if m is not None))
def test_mutation_text_occurs_once_in_its_source(name):
    source, text, replacement = MUTATIONS[name]
    code = (CSRC / source).read_text()
    assert code.count(text) == 1
    assert replacement != text
    assert replacement not in code


def test_mutations_cover_every_kernel_and_the_unmodified_copy():
    assert MUTATIONS["none"] is None
    sources = {m[0] for m in MUTATIONS.values() if m is not None}
    # The three flash redesigns, which the main case runs, and the two
    # Hopper serving forms, which the serving phase runs.
    assert sources == {"flash_fwd_sm90.cuh", "flash_bwd_dkdv_sm90.cuh",
                       "flash_bwd_dq_sm90.cuh", "serving_gemm_sm90.cuh",
                       "cache_attention_sm90.cuh"}
    assert sources == set(_TOOL.PHASE_OF_SOURCE)
    for kernel in ("fwd", "dkdv", "dq"):
        kinds = [n for n in MUTATIONS if n.startswith(kernel + "_")]
        assert any("5pct_low" in n for n in kinds), kernel
        assert any("diagonal" in n for n in kinds), kernel


def test_serving_mutations_break_each_rule_of_the_hopper_forms():
    """The last K tile, the split order, the last key tile, the mask's
    source and the masked tail's zeroing: each run by the serving
    phase."""
    serving = {n for n, m in MUTATIONS.items()
               if m is not None and _TOOL.PHASE_OF_SOURCE[m[0]] == "serving"}
    assert serving == {"gemm_last_k_tile_dropped",
                       "gemm_split_sum_order_by_rows",
                       "attention_last_key_tile_skipped",
                       "attention_mask_from_row_index",
                       "attention_tail_zeroing_removed"}
