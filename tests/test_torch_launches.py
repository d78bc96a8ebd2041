"""Launch counts under CUDA graph capture (kfnet_tpu_torch.kernels.launches).

A wrapper's count is the launches of its kernel that ran: one for a call
outside a capture; a call inside a capture is recorded instead and counted
once for each replay. The capture state is simulated here (no device).
"""

import pytest
import torch

from kfnet_tpu_torch.kernels import launches


def _wrapper():
  def fn():
    pass
  fn.launches = 0
  return fn


@pytest.fixture
def capturing(monkeypatch):
  state = {"on": False}
  monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                      lambda: state["on"])
  return state


def test_eager_launches_count_once(capturing):
  a = _wrapper()
  launches.count(a)
  launches.count(a)
  assert a.launches == 2


def test_captured_launches_count_per_replay(capturing):
  a, b = _wrapper(), _wrapper()
  launches.count(a)
  with launches.recorded() as record:
    capturing["on"] = True
    for _ in range(3):
      launches.count(a)
    launches.count(b)
    capturing["on"] = False
  assert (a.launches, b.launches) == (1, 0)  # recorded, not run
  assert record == {a: 3, b: 1}
  for _ in range(2):
    launches.replayed(record)
  assert (a.launches, b.launches) == (7, 2)


def test_nested_records_and_unrecorded_captures(capturing):
  a = _wrapper()
  capturing["on"] = True
  launches.count(a)  # a capture nobody records: never counted
  with launches.recorded() as outer:
    launches.count(a)
    with launches.recorded() as inner:
      launches.count(a)
    launches.count(a)
  assert a.launches == 0
  assert outer == {a: 2} and inner == {a: 1}
  capturing["on"] = False
  launches.count(a)  # the blocks are closed: counted as run
  assert a.launches == 1
