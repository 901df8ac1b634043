"""The CPU rehearsal of chip_smoke.py's phases for the calibration scripts and the
tools (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"calib_and_tools": ("calib", "tools")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
