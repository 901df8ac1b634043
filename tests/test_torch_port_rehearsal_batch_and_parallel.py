"""The CPU rehearsal of chip_smoke.py's phases for the batched odometry and the
multi-process paths (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"batch_and_parallel": ("batch", "parallel")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
