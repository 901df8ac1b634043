"""The CPU rehearsal of chip_smoke.py's phases for the kernels, the networks and
the odometry on the clip (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"kernels_and_odometry": ("kernel", "network", "gt", "performant", "fast", "tartanvo", "synthetic", "paper",
                                  "ablation")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
