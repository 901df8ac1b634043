"""The CPU rehearsal of chip_smoke.py's phases for the odometry runner, the
pose-net trainer and the batch runner (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"runners": ("runner", "posenet", "experiment")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
