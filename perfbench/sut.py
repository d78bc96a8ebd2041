"""The system under test: the program's configuration objects made from a
configuration file, and the modules the loops call. Everything the
benchmark takes from the program goes through here."""

from __future__ import annotations


def modules():
  """The program's modules that the loops and the spans reach."""
  from kfnet_tpu_torch.eval import online
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers
  from kfnet_tpu_torch.pose import ransac
  return {"online": online, "sequence": sequence, "kfnet": kfnet,
          "layers": layers, "ransac": ransac}


def kfnet_config(cfg: dict):
  from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
  sc, of = dict(cfg["scoordnet"]), dict(cfg["oflownet"])
  for key in ("channels", "strides", "coord_offset"):
    sc[key] = tuple(sc[key])
  for key in ("encoder_channels", "encoder_strides", "unet_channels"):
    of[key] = tuple(of[key])
  return kfnet.KFNetConfig(scoordnet=scoordnet.SCoordNetConfig(**sc),
                           oflownet=oflownet.OFlowNetConfig(**of),
                           **cfg["filter"])


def ransac_config(cfg: dict):
  from kfnet_tpu_torch.pose import ransac
  return ransac.RansacConfig(**cfg["ransac"])


def build_kernels(device) -> None:
  """Build (or load from the checkout's build directory) the fused
  update's library, so that no build falls inside the window."""
  if device.type == "cuda":
    from kfnet_tpu_torch.kernels import fused_filter
    fused_filter.build()
