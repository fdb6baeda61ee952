"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware
(the reference has no multi-node testing at all; see SURVEY.md section 4).

Tests that only the GPU can run carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here with a reason.
"""

import os

import pytest

flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

# The XLA persistent compilation cache is kept off for the CPU tier, here
# and in the subprocesses the tests start: XLA:CPU's AOT reload reports a
# compile-host/run-host machine-feature mismatch and measured slower than
# a fresh compile. The grid-payload disk cache
# (gridcollapse.payload_cache_dir) covers the expensive node sweeps.
os.environ['JAX_ENABLE_COMPILATION_CACHE'] = 'false'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
jax.config.update('jax_enable_compilation_cache', False)


@pytest.fixture
def gpu_card():
    """Skips the test unless the machine has an NVIDIA GPU. The test
    process itself stays on the CPU backend (pinned above), so a test
    that needs the card drives it from a subprocess."""
    import shutil
    import subprocess
    smi = shutil.which('nvidia-smi')
    listed = ''
    if smi is not None:
        listed = subprocess.run([smi, '-L'], capture_output=True,
                                text=True, timeout=60).stdout
    if 'GPU' not in listed:
        pytest.skip('needs an NVIDIA GPU; on the card run '
                    "`python -m pytest tests/ -m gpu`")
