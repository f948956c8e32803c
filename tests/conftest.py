import os

# Tests run on a simulated 8-device CPU mesh (SURVEY.md section 4): fast,
# deterministic, and exercises the same sharding code paths the driver
# validates via dryrun_multichip.
# The platform is also pinned through jax.config before any backend
# starts, so a GPU on the test machine is never used.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
