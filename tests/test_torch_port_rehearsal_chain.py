"""The CPU rehearsal of chip_smoke.py's phase for the shipped checkpoint's
training chain: worlds, flow, cov, fit and calibration, promotion gate and the
multi-sequence recipe (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"chain": ("chain",)}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
