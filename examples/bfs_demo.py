"""BFS demo — the reference's Demo/Program/bfs analog, using both the GrB
op tier and the fused tier.  Run: python examples/bfs_demo.py"""

import sys, pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import jax

if __name__ == "__main__":
    import numpy as np
    import scipy.sparse as sps

    import graphblas_tpu as gb
    from graphblas_tpu import algorithms as alg

    gb.init()
    gb.set_option("burble", True)

    rng = np.random.default_rng(0)
    n = 1000
    S = sps.random(n, n, 0.005, format="csr", random_state=0)
    S = ((S + S.T) != 0).astype(np.float32)
    A = gb.Matrix.from_scipy(S)
    print(f"graph: {A}")

    levels = alg.bfs_levels(A, source=0)
    lv, lp = levels.to_dense_1d()
    print(f"GrB-tier BFS: reached {int(lp.sum())} vertices, "
          f"max level {int(lv.max())}")

    fused = alg.bfs_levels_fused(A, 0)
    print(f"fused-tier BFS agrees: "
          f"{bool((np.asarray(fused) >= 0).sum() == int(lp.sum()))}")

    parents = alg.bfs_parents(A, 0)
    print(f"parent tree entries: {parents.nvals}")
