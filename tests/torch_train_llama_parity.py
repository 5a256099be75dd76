"""Training losses of both packages on llama3.2-1b cut to 2 layers at full
width (fp32, batch 2 x 64, ``SyntheticLM`` batches), from the same numpy
state (the port's seeded ``init_params``), with the reference CLI's
optimizer: lr 3e-3, warm-up 20, ``total_steps`` 20 (the CLI at
``--steps 20``). Prints the 10 steps' losses side by side and the largest
difference. Not a pytest file: each package holds about 10 GB of state,
so the packages run one after the other in processes of their own:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_llama_parity.py
"""

import dataclasses
import json
import subprocess
import sys

STEPS, BATCH, SEQ = 10, 2, 64


def losses(which: str) -> list[dict]:
    import numpy as np  # noqa: F401  (both sides take the state as numpy)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optimizer as O

    torch.set_num_threads(4)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    np_params = O.tree_map(lambda t: t.numpy(), T.init_params(cfg, seed=0, device="cpu"))
    out = []
    if which == "torch":
        from repro_torch.bridge import params_from_numpy
        from repro_torch.parallel.ctx import ParallelCtx
        from repro_torch.runtime import train as TR
        from repro_torch.runtime.data import DataConfig, SyntheticLM

        params = params_from_numpy(np_params)
        state = {"params": params, "opt": O.adamw_init(params)}
        step = TR.make_train_step(cfg, ParallelCtx(),
                                  O.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=20))
        data = SyntheticLM(DataConfig(cfg.vocab_size, BATCH, SEQ))
    else:
        import jax
        import jax.numpy as jnp

        from repro.configs import get_config as jget
        from repro.parallel.ctx import ParallelCtx as JCtx
        from repro.runtime import data as JD
        from repro.runtime import optimizer as JO
        from repro.runtime import train as JTR

        jcfg = dataclasses.replace(jget("llama3.2-1b"), n_layers=2)
        params = jax.tree.map(jnp.asarray, np_params)
        state = {"params": params, "opt": JO.adamw_init(params)}
        step = jax.jit(JTR.make_train_step(
            jcfg, JCtx(), JO.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=20)),
            donate_argnums=(0,))
        data = JD.SyntheticLM(JD.DataConfig(jcfg.vocab_size, BATCH, SEQ))
    for i in range(STEPS):
        state, met = step(state, data.batch_at(i))
        out.append({k: float(v) for k, v in met.items()})
    return out


def main() -> None:
    if len(sys.argv) > 1:
        print(json.dumps(losses(sys.argv[1])))
        return
    runs = {}
    for which in ("torch", "jax"):
        res = subprocess.run([sys.executable, __file__, which], capture_output=True,
                             text=True, check=True)
        runs[which] = json.loads(res.stdout.strip().splitlines()[-1])
    worst = 0.0
    for i, (t, j) in enumerate(zip(runs["torch"], runs["jax"], strict=True)):
        worst = max(worst, abs(t["loss"] - j["loss"]))
        print(f"step {i}: loss port {t['loss']:.6f} reference {j['loss']:.6f} "
              f"lr {t['lr']:.3e} gnorm {t['grad_norm']:.4f} / {j['grad_norm']:.4f}")
    print(f"largest loss difference {worst:.3g}")


if __name__ == "__main__":
    main()
