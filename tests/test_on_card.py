"""Checks that need an NVIDIA GPU: each formulation the card picks against
its plain reference, at real widths. On a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_formulations_match_references_on_card(gpu):
    rec = chip_smoke.parity_formulations(batch=16)
    assert all(rec[k] for k in rec if k.startswith("ldpc"))


def test_deep_scans_match_float64_on_card(gpu):
    chip_smoke.parity_deep_scans(batch=16)
