"""The synthetic protocol's scene table (from ``kfnet_tpu/tools/protocol.py``):
the scenes the JAX package's multi-scene dress rehearsal of the three-stage
training recipe trains and evaluates, each with its seed and world scale.

Only ``SceneSpec`` and ``DEFAULT_SCENES`` are here so far: the soak
(``tools/soak.py``) takes a scene's regime from them. The rehearsal itself
(train stages 1-3 over these scenes, then the filtered and
measurement-only eval) is still to be ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SceneSpec:
  name: str
  seed: int
  scale: float = 1.0        # world scale (20 ≈ Cambridge outdoor)
  dataset: str = "indoor"   # OFlowNet is trained per dataset
  held_out: bool = False    # excluded from OFlowNet (+joint) training


DEFAULT_SCENES = (
    SceneSpec("sceneA", seed=0),
    SceneSpec("sceneB", seed=10),
    SceneSpec("sceneC", seed=20),
    SceneSpec("heldout", seed=30, held_out=True),
    # the outdoor "dataset": OFlowNet trains on outdoor_train only, so the
    # outdoor eval scene is also a transfer test at 20x coordinate scale
    SceneSpec("outdoor_train", seed=50, scale=20.0, dataset="outdoor"),
    SceneSpec("outdoor", seed=40, scale=20.0, dataset="outdoor",
              held_out=True),
)
