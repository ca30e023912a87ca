"""Regenerate the JAX-written checkpoint fixture beside this script.

The tiny Llama preset in bfloat16, with a warmup schedule, after one train
step on a batch drawn from numpy seed 0, saved at step 1 by the JAX
package's ``Checkpointer`` (Orbax: OCDBT, zarr v2, zstd level 1) into
``orbax/`` and by its ``NpzCheckpointer`` into ``npz/``. The port's tests
(tests/test_torch_ocdbt.py, tests/test_torch_orbax.py) and ``chip_smoke.py``
(the ``orbax-jax-step`` phase, on a machine without JAX) read both.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/data/orbax_llama_tiny/make_fixture.py
"""

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from nexus_tpu.utils.hw import force_platform  # noqa: E402

force_platform("cpu", num_cpu_devices=1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nexus_tpu.models import llama  # noqa: E402
from nexus_tpu.train import checkpoint, trainer  # noqa: E402

STEP = 1


def main():
    cfg = llama.config("tiny", dtype=jnp.bfloat16)
    opt = trainer.build_optimizer(3e-3, warmup_steps=2, total_steps=8)
    state = trainer.init_train_state(lambda: llama.init(jax.random.PRNGKey(0), cfg), opt)
    step = trainer.make_train_step(lambda p, b: llama.loss_fn(p, cfg, b), opt)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    state, _ = step(state, {"tokens": jnp.asarray(tokens)})
    assert int(state.step) == STEP
    for sub in ("orbax", "npz"):
        shutil.rmtree(os.path.join(HERE, sub), ignore_errors=True)
    ck = checkpoint.Checkpointer(os.path.join(HERE, "orbax"))
    ck.save(state, wait=True)
    ck.close()
    checkpoint.NpzCheckpointer(os.path.join(HERE, "npz")).save(state)


if __name__ == "__main__":
    main()
