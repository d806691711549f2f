"""Context demo — the reference's Demo/Program/context_demo analog
(nested user parallelism: per-thread GxB_Context dividing resources).
Here several host threads run GraphBLAS ops concurrently, each under its
own Context; JAX serializes device work safely, and the contexts carry
per-thread dispatch settings.  Run: python examples/context_demo.py"""

import sys
import pathlib
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import scipy.sparse as sps
    import graphblas_tpu as gb
    from graphblas_tpu.core.context import Context

    gb.init()
    rng = np.random.default_rng(0)
    S = sps.random(500, 500, 0.01, format="csr", random_state=0)
    A = gb.Matrix.from_scipy(S)
    results = {}

    def worker(tid, chunk):
        with Context(chunk=chunk, name=f"worker{tid}"):
            x = gb.Vector.from_dense(np.ones(500))
            y = gb.mxv(A, x, gb.semiring.PLUS_TIMES)
            results[tid] = float(np.asarray(
                gb.reduce_scalar(y, gb.monoid.PLUS)))

    threads = [threading.Thread(target=worker, args=(i, 4096 << i))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("per-thread results (all equal):", results)
    assert len(set(results.values())) == 1
