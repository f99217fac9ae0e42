"""Test configuration: CPU backend with 8 virtual devices (multi-chip
sharding tests without hardware) and x64 enabled (exact f64 goldens).

Must run before the first `import jax` anywhere in the test session.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Hermetic CPU tests: pinning the default device to the CPU routes
# every computation (and `utils.device.default_platform`) to the host
# even where an accelerator is visible. The kernels run here in Pallas
# interpret mode; on the card, `python chip_smoke.py` checks them.
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import pytest  # noqa: E402

FIRA = "/root/reference/testdata/Fira Sans - Regular.ttf"
NOTO_DIR = "/root/reference/testdata/Noto Sans"
NOTO = NOTO_DIR + "/Noto Sans - Regular.ttf"
NOTO_ARABIC = NOTO_DIR + "/Noto Sans Arabic - Regular.ttf"
NOTO_TAMIL = NOTO_DIR + "/Noto Sans Tamil - Regular.ttf"

HAVE_TESTDATA = os.path.exists(FIRA)

# Modules whose tests open reference testdata paths directly (not via
# the fixtures below).
_NEEDS_TESTDATA_MODULES = {
    "test_cli", "test_font", "test_index", "test_fitting", "test_balance",
}


def pytest_collection_modifyitems(config, items):
    """Hermetic CI (no /root/reference checkout): skip every test that
    reads the reference testdata fonts; the synth-font/geometry/wire
    suites still run."""
    if HAVE_TESTDATA:
        return
    skip = pytest.mark.skip(reason="reference testdata absent")
    for item in items:
        fx = getattr(item, "fixturenames", ())
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if "fira_entry" in fx or "noto_entry" in fx or mod in _NEEDS_TESTDATA_MODULES:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def fira_entry():
    from versatiles_glyphs_tpu.font.entry import FontFileEntry

    with open(FIRA, "rb") as f:
        return FontFileEntry(f.read())


@pytest.fixture(scope="session")
def noto_entry():
    from versatiles_glyphs_tpu.font.entry import FontFileEntry

    with open(NOTO, "rb") as f:
        return FontFileEntry(f.read())
