"""K3's float32 A/B script, rehearsed on the CPU (no card, no nvcc): what
scripts/flash_attention_f32_ab.py would build and call is checked against
the source it edits and the entry point it binds.

- Every edit of every variant applies to csrc/flash_attention_f32.cu
  exactly once (a variant that no longer matches the kernel fails here,
  not on the card), and the variants that change the source change it.
- The script binds `ltd_flash_attention_f32` with the port's argument
  types, which match the C function's parameters one for one.
"""

import re

import pytest

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.scripts import flash_attention_f32_ab as ab


@pytest.mark.parametrize("name", sorted(ab.EDITS))
def test_ab_variant_edits_apply_once(name):
    source = (_build.CSRC / ab.SOURCE).read_text()
    got = ab.variant_source(name)
    assert (got == source) == (not ab.EDITS[name])
    for old, new in ab.EDITS[name]:
        assert source.count(old) == 1
        assert got.count(new) >= 1


def test_ab_variant_edits_refuse_a_changed_source(monkeypatch, tmp_path):
    """An edit whose text is not in the source raises."""
    (tmp_path / ab.SOURCE).write_text("// no kernel here\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        ab.variant_source("no turns")


def test_ab_script_binds_the_entry_point():
    source = (_build.CSRC / ab.SOURCE).read_text()
    decl = re.search(rf"LTD_API int {ab.ENTRY}\(([^)]*)\)", source)
    assert decl is not None
    params = [p.strip() for p in decl.group(1).split(",")]
    assert len(params) == len(_build.SIGNATURES[ab.ENTRY])
    # pointers where the signature has pointers, ints where it has ints
    for param, ctype in zip(params, _build.SIGNATURES[ab.ENTRY]):
        assert ("*" in param) == (ctype.__name__ == "c_void_p"), (param, ctype)


def test_ab_bound_is_the_3xtf32_operations():
    """At the timed shapes the bound is the operations at a third of the
    TF32 rate (the bytes take less): 1.249 ms at 512 px, 2.499 at 1024 px."""
    assert ab.bound_ms(64, 1024, 1024, 12) == pytest.approx(1.2493, abs=1e-3)
    assert ab.bound_ms(8, 4096, 4096, 12) == pytest.approx(2.4986, abs=1e-3)
    ops = 4 * 64 * 12 * 256 * 256 * 64 / (ab.TF32_FLOP_S / 3) * 1e3
    assert ab.bound_ms(64, 256, 256, 12) == pytest.approx(ops)
