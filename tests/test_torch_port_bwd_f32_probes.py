"""The float32 attention backward's probe scripts, rehearsed on the CPU
(no card, no nvcc): what they would build and call is checked against the
sources they edit or bind.

- scripts/attn_bwd_f32_parts.py builds copies of
  csrc/flash_attention_bwd_f32.cu with parts of the work removed: every
  edit of every variant still applies to the kernel exactly once.
- scripts/tf32_wgmma_rate.py builds its own source: its table of forms
  matches the source's launch cases.
- scripts/attn_bwd_f32_ab.py binds an earlier checkout's entry points:
  the port's, or the self-attention's one-kernel entry point, which the
  current sources no longer hold.
"""

import re

import pytest

from transformer_latent_diffusion_tpu_torch.ops import _build
from transformer_latent_diffusion_tpu_torch.scripts import attn_bwd_f32_ab as ab
from transformer_latent_diffusion_tpu_torch.scripts import attn_bwd_f32_parts as parts
from transformer_latent_diffusion_tpu_torch.scripts import tf32_wgmma_rate as rate


@pytest.mark.parametrize("name", sorted(parts.EDITS))
def test_parts_probe_edits_apply_once(name):
    source = (_build.CSRC / parts.SOURCE).read_text()
    got = parts.variant_source(name)
    assert (got == source) == (not parts.EDITS[name])
    for old, new in parts.EDITS[name]:
        assert got.count(new) >= 1


def test_parts_probe_binds_the_kernels_entry_points():
    source = (_build.CSRC / parts.SOURCE).read_text()
    for fn in parts.ENTRIES:
        assert f"LTD_API int {fn}(" in source
        assert fn in _build.SIGNATURES


def test_tf32_rate_forms_match_the_source_cases():
    cases = re.findall(r"L\((\d+), (\d+), (\d), (\d), (true|false)\)", rate.SOURCE)
    assert [int(c[0]) for c in cases] == list(range(len(rate.FORMS)))
    for (which, n, wgs, wait, split), (name, f_n, f_wgs, f_split) in zip(cases, rate.FORMS):
        assert (int(n), int(wgs), split == "true") == (f_n, f_wgs, f_split), name
        assert f"wait{wait}" in name or (wait == "2" and "nowait" in name), name


def test_ab_script_binds_the_earlier_entry_points():
    """The A/B script binds the port's entry points where an earlier
    library has them, and else the one-kernel self-attention entry point,
    which the current sources no longer hold."""
    for fn in ab.ENTRIES:
        assert fn in _build.SIGNATURES
    assert ab.ONE_KERNEL[0] not in _build.SIGNATURES
    assert not (_build.CSRC / "attention_bwd_f32.cu").exists()
