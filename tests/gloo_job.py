"""One job of gloo ranks for the port's multi-rank parity tests.

The parent writes the inputs to an ``.npz``, starts ``n`` worker
processes (a ``FileStore`` in the test's tmp directory, so the tests are
xdist-safe), runs the reference while they work and then reads each
rank's ``.npz`` of results.  A worker is :data:`PRELUDE` followed by the
test file's own code; the prelude joins the group, initialises
horovod_tpu_torch on the CPU and loads the inputs as ``D``, and
``finish(out)`` saves the results.  Trees travel flat, their leaves
named by ``/``-joined keys (``prefix/Dense_0/kernel``).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    RANK, STORE, DATA, OUT = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
    N = int(sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(STORE, N),
                            rank=RANK, world_size=N)
    hvd.init(device="cpu")
    D = dict(np.load(DATA))


    def tree(prefix, requires_grad=True):
        '''The tree stored under prefix/, carried across as the port's
        tensors by utils/convert.py.'''
        from horovod_tpu_torch.utils.convert import params_from_jax

        out = {}
        for key, value in D.items():
            if key.startswith(prefix + "/"):
                path = key[len(prefix) + 1:].split("/")
                node = out
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = value
        return params_from_jax(out, requires_grad=requires_grad)


    def flat(prefix, t):
        '''A tree of tensors as {prefix/path: array}.'''
        from horovod_tpu_torch.utils.tree import tree_named_leaves

        return {f"{prefix}/{k}": v.detach().numpy()
                for k, v in tree_named_leaves(t)}


    def rows(x, n=N, r=RANK):
        '''This rank's rows of a global batch.'''
        size = x.shape[0] // n
        return x[r * size:(r + 1) * size]


    def save(out):
        np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
        print("WORKER_OK", RANK, flush=True)


    def finish(out):
        hvd.shutdown()
        dist.destroy_process_group()
        save(out)
""")

# Test optimizers, shared by the sharded-step tests and their workers: the torch
# counterparts of optax.chain(clip_by_global_norm(m), sgd(lr)) (it
# aggregates over every tensor it holds) and of optax.chain(clip(d),
# sgd(lr)) (per element), and one whose state is not a per-parameter
# slice.
OPTIMIZERS = textwrap.dedent("""
    class GlobalNormClipSGD(torch.optim.Optimizer):
        def __init__(self, params, lr, max_norm):
            super().__init__(params, dict(lr=lr, max_norm=max_norm))

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                grads = [p.grad for p in group["params"]]
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                for p, g in zip(group["params"], grads):
                    if not norm < group["max_norm"]:
                        g = g / norm * group["max_norm"]
                    p.add_(g, alpha=-group["lr"])


    class ClampSGD(torch.optim.Optimizer):
        def __init__(self, params, lr, delta):
            super().__init__(params, dict(lr=lr, delta=delta))

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                for p in group["params"]:
                    p.add_(p.grad.clamp(-group["delta"], group["delta"]),
                           alpha=-group["lr"])


    class TableSGD(torch.optim.Optimizer):
        def __init__(self, params, lr):
            super().__init__(params, dict(lr=lr))

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                for p in group["params"]:
                    self.state[p]["lr_table"] = torch.ones(3)
                    p.add_(p.grad, alpha=-group["lr"])
""")



def named(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, keys sorted."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def flat(tree, prefix):
    """A nested dict of arrays as ``{prefix/path: array}``."""
    return {f"{prefix}/{k}": np.asarray(v) for k, v in named(tree)}


def to_tree(leaves, fn=lambda x: x):
    """``{path: leaf}`` -> the nested dict, ``fn`` applied to each leaf."""
    out = {}
    for k, v in leaves.items():
        *path, leaf = k.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = fn(v)
    return out


def unflat(out, prefix):
    """``{path: array}`` of the leaves stored under ``prefix/``."""
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


class GlooJob:
    """``n`` worker processes running ``PRELUDE + code`` on ``data``."""

    def __init__(self, tmp, code, n, data, timeout=240, env=None,
                 head=""):
        """``env`` is added to the workers' environment; ``head`` is code
        that runs before the prelude (a module blocked in
        ``sys.modules``)."""
        self.tmp, self.n, self.timeout = tmp, n, timeout
        data_path = tmp / "data.npz"
        np.savez(data_path, **data)
        script = tmp / "worker.py"
        script.write_text(textwrap.dedent(head) + PRELUDE
                          + textwrap.dedent(code))
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **(env or {})}
        for k in ("RANK", "WORLD_SIZE", "HVD_TPU_FUSE",
                  "HVD_TPU_FUSE_CHUNKS"):
            env.pop(k, None)
        self.procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(tmp / "store"),
             str(data_path), str(tmp / f"out{r}.npz"), str(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(n)]

    def results(self):
        """Each rank's results; asserts that every rank finished."""
        try:
            logs = [p.communicate(timeout=self.timeout)[0]
                    for p in self.procs]
        finally:
            self.kill()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
        return [dict(np.load(self.tmp / f"out{r}.npz"))
                for r in range(self.n)]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
