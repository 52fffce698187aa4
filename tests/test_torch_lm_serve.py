"""Port parity: the continuous-batching server and its launcher against
the JAX package, on the CPU, at reduced width.

With the same parameters (carried across with ``convert``), the same
seeded prompts, 2 slots, ``cache_len=64`` and ``max_new=6`` (the JAX
package's ``test_serve_drains_and_is_greedy_consistent``), at float32
compute, the port's ``Server`` must give every request the same greedy
tokens as ``repro.serve.server.Server``: argmax of logits that agree to
1e-4 (``test_torch_lm_model.py``), with no near ties in these draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.serve.server import Request as JRequest, Server as JServer

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serve.server import Request, Server

torch.set_num_threads(1)


def _requests(cls, vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, int(rng.integers(
        2, 9))).astype(np.int32), max_new=6) for rid in range(n)]


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.rid: list(r.out) for r in server.run_until_drained()}


def test_server_gives_the_jax_servers_greedy_tokens():
    cfg_j = dataclasses.replace(jregistry.reduced("tinyllama-1.1b"),
                                compute_dtype="float32")
    cfg_t = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                                compute_dtype="float32")
    pj = japi.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu",
                                   cfg_t)
    jsrv = JServer(cfg_j, pj, slots=2, cache_len=64)
    want = _drain(jsrv, _requests(JRequest, cfg_j.vocab))
    srv = Server(cfg_t, pt, slots=2, cache_len=64, device="cpu")
    got = _drain(srv, _requests(Request, cfg_t.vocab))
    assert len(got) == 5 and all(len(o) == 6 for o in got.values())
    assert got == want
    # one shared write index, advanced once per batched decode step (each
    # prompt token one step, then one per generated token), as in JAX
    assert srv.cache["idx"].dtype == torch.int32
    assert int(srv.cache["idx"]) == int(jsrv.cache["idx"])


def test_server_samples_at_a_temperature_from_its_seed():
    cfg = registry.reduced("tinyllama-1.1b")
    params = api.init_params(cfg, 1, "cpu")
    outs = []
    for _ in range(2):
        srv = Server(cfg, params, slots=2, cache_len=32, temperature=1.0,
                     seed=3, device="cpu")
        outs.append(_drain(srv, _requests(Request, cfg.vocab, n=3)))
    assert outs[0] == outs[1]
    assert all(len(o) == 6 and all(0 <= t < cfg.vocab for t in o)
               for o in outs[0].values())


def test_serve_launcher_on_the_cpu(capsys):
    serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--requests", "3",
                "--max-new", "4", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("served 3 requests / 12 tokens in ")
    assert line.endswith("with 4 slots on cpu")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "hymba-1.5b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_serve_launcher_serves_every_family_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("served 3 requests / 12 tokens in ")
    assert line.endswith("with 2 slots on cpu")
