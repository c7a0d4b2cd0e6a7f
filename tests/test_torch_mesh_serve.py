"""``launch/serve`` on the JAX launcher's mesh: 4 gloo CPU ranks under a
launcher's environment, so ``setup`` builds the (4, 1) (data, model) mesh
and each rank prefills and decodes its own slots. One spawn serves every
case (``CASES``: the four decoder families at the reduced preset, fp32, 8
slots, 12 requests of 8 tokens, 4 new: swaps happen; and 6 slots, which 4
ranks do not divide, replicated by the rules' fallback), each held to the
launcher in one plain process with no mesh: the streams, ``served`` and
``n_decoded`` equal, the last step's logits within 1e-5 (each rank's rows
go through products of 2 rows, not 8, which round otherwise), the cache
after the last step equal bit for bit. The schedule (``served``,
``n_decoded``) is also the JAX launcher's (``repro.launch.serve.main`` at
the same flags).
"""
import re

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve
from torch_mesh_workers import serve_mesh_worker, spawn

ARCHS = ("qwen3-4b", "moonshot-v1-16b-a3b", "mamba2-2.7b", "zamba2-7b")


def flags(arch, slots=8):
    return ["--arch", arch, "--preset", "reduced", "--slots", str(slots),
            "--requests", "12", "--prompt-len", "8", "--max-new", "4",
            "--seed", "0"]


CASES = [(arch, 8) for arch in ARCHS] + [("qwen3-4b", 6)]


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """Every case served on the (4, 1) mesh in one spawn of 4 ranks."""
    path = str(tmp_path_factory.mktemp("serve_mesh") / "out.pt")
    spawn(serve_mesh_worker, 4,
          [flags(a, s) + ["--device", "cpu"] for a, s in CASES], path,
          timeout=240)
    return dict(zip(CASES, torch.load(path, weights_only=False)))


def one_process(arch, slots):
    args, cfg, params, requests = serve.setup(flags(arch, slots)
                                              + ["--device", "cpu"])
    assert args.mesh is None
    last = {}
    res = serve.serve(cfg, params, requests, slots=args.slots,
                      max_new=args.max_new, device="cpu",
                      on_step=lambda step, cache, logits:
                      last.update(logits=logits))
    return res, last["logits"]


@pytest.mark.parametrize("arch,slots", CASES)
def test_serve_on_the_4x1_mesh_matches_one_process(meshed, arch, slots):
    got = meshed[(arch, slots)]
    want, logits = one_process(arch, slots)
    assert got["streams"] == want.streams
    assert (got["served"], got["n_decoded"]) == (want.served, want.n_decoded)
    assert want.served == 12 and want.n_decoded == slots * 8  # 2 rounds
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert got["cache"].keys() == want.cache.keys()
    for key, w in want.cache.items():
        assert torch.equal(got["cache"][key], w), key


@pytest.mark.parametrize("arch,slots", CASES)
def test_serve_mesh_schedule_is_the_jax_launcher_s(meshed, arch, slots,
                                                   capsys):
    got = meshed[(arch, slots)]
    n = jserve.main(flags(arch, slots))
    served = int(re.search(r"\[serve\] (\d+) requests",
                           capsys.readouterr().out).group(1))
    assert (got["served"], got["n_decoded"]) == (served, n)
