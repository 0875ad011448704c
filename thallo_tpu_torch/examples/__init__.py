"""The port's example drivers (counterparts of the repo's ``examples/*.py``
and ``scripts/gallery.py``).  Each is a module with ``main(argv=None)``
and a ``--device`` flag whose default is ``cuda``; run one as
``python -m thallo_tpu_torch.examples.<name> [--device cpu] ...``.
Outputs go under ``results/``."""
from pathlib import Path

# the repo's committed sample data (BAL scene, PLY mesh)
DATA_DIR = Path(__file__).resolve().parents[2] / "examples" / "data"


def unknown(plan, name):
    """An unknown of a solved plan as a numpy array on the host."""
    return plan.get_unknown(name).detach().cpu().numpy()
