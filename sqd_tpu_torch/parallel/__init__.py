# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Sharded SQD execution on ``torch.distributed`` (port of ``sqd_tpu.parallel``).

One process per rank; the mesh axes of ``sqd_tpu`` are the named dimensions
of a ``DeviceMesh`` (:mod:`.mesh`), joined by :func:`init_distributed`:

* :func:`solve_sci_batch_sharded` — the loop's batches dealt over the ranks
  (the ``sci_solver`` seam);
* :func:`solve_sci_distributed` — one solve, the excitation-pair axis sharded;
* :func:`solve_sci_rowsharded` / :func:`solve_sci_batch_rowsharded` — one
  solve, the alpha rows (amplitudes and Krylov buffers) sharded;
* :func:`solve_sci_gridsharded` — one solve, the amplitude grid sharded in 2-D;
* :func:`solve_sci_dfsharded` — one solve, the density-fitting factor sharded.

Entry points run on the card (``device="cuda"``) unless the caller passes
another device.  :mod:`.dryrun` runs the five modes on several ranks.
"""

from .batch_solver import solve_sci_batch_sharded  # noqa: F401
from .df_sharded import solve_sci_dfsharded  # noqa: F401
from .distributed import global_mesh, init_distributed, is_distributed  # noqa: F401
from .grid_sharded import default_grid_mesh, solve_sci_gridsharded  # noqa: F401
from .row_sharded import solve_sci_batch_rowsharded, solve_sci_rowsharded  # noqa: F401
from .sharded_solve import solve_sci_distributed  # noqa: F401
from .mesh import batch_sharding, default_mesh  # noqa: F401
