"""The `kimi-linear.wholechapters` cell on the CPU: its configuration, its
operation counts against hand counts, the reference's block form against
its token loop and against the port's CPU path, a rehearsal from a copy of
the benchmark, and the check failing under planted faults and under the
control (the reference in float8 in the program's place).

    python -m pytest benchmark/tests/test_bench_kimi_linear.py -q
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run
from benchmark.drivers import kimi_linear as drv
from benchmark.reference import kimi_linear as ref_kimi

SEED = 2_900_000_041
CELL = "kimi-linear.wholechapters"
FULL = drv.dims_of(harness.Cell(harness.load_spec(), CELL).config)


def _tiny() -> dict:
    cell = harness.Cell(harness.load_spec(), CELL)
    model_cfg, _ = drv.closed_loop.settings(cell, rehearse=True)
    return drv.dims_of(model_cfg)


def test_the_cell_and_its_driver_are_found_by_name():
    cell = harness.Cell(harness.load_spec(), CELL)
    assert run._driver(cell) is drv
    assert cell.chips == 1 and cell.config_entry["reduced"] == cell.config["reduced"] == \
        ["num_experts"]
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "task_self_ms_per_job", "llm_prefill_ms_per_ktoken", "llm_decode_ms_per_step",
        "llm_decode_graph_pct", "moe_roofline", "kda_prefill_pct", "mfu_pct.wholechapters",
        "device_idle_pct.wholechapters"}


def test_the_configuration_holds_every_published_size():
    """The catalog's config.json keys, each as published but the experts
    held (128 of the router's 256, listed in `reduced`)."""
    want = {"first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
            "intermediate_size": 9216, "kv_lora_rank": 512, "mla_use_nope": True,
            "model_max_length": 1048576, "model_type": "kimi_linear",
            "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
            "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
            "num_expert_group": 1, "num_experts_per_token": 8, "num_hidden_layers": 27,
            "num_key_value_heads": 32, "num_nextn_predict_layers": 0, "num_shared_experts": 1,
            "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "rms_norm_eps": 1e-5, "rope_scaling": None, "rope_theta": 10000,
            "routed_scaling_factor": 2.446, "tie_word_embeddings": False, "topk_group": 1,
            "use_grouped_topk": True, "v_head_dim": 128, "vocab_size": 163840,
            "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
                                   "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18,
                                                  19, 21, 22, 23, 25, 26],
                                   "num_heads": 32, "short_conv_kernel_size": 4}}
    assert {k: FULL[k] for k in want} == want
    assert (FULL["num_experts"], FULL["num_router_experts"], FULL["first_held_expert"]) == \
        (128, 256, 0)


def test_token_flops_against_a_hand_count():
    d, w, r = 2304, 4096, 128
    kda = 2 * d * (3 * w + 2 * r + 32) + 2 * 2 * r * w + 2 * w * d + 2 * 3 * w * 4
    mla = 2 * d * (32 * 192 + 576) + 2 * 512 * 32 * 256 + 2 * 32 * 128 * d + 2 * 32 * 320 * 1000
    sparse = 2 * d * 256 + 2 * 3 * d * 1024 * (8 * 128 / 256 + 1)
    want = 20 * kda + 7 * mla + 2 * 3 * d * 9216 + 26 * sparse + 2 * d * 163840
    assert drv.token_flops(FULL, 1000, True) == pytest.approx(want, rel=1e-12)
    # decoding adds the recurrence's three products a head in 20 layers
    assert drv.token_flops(FULL, 1000, True, decode=True) - want == \
        pytest.approx(20 * 2 * 3 * r * r * 32)
    # about 4.0 GFLOP a token at the held share, past the logits
    assert 3.9e9 < drv.token_flops(FULL, 0, False) < 4.1e9


def test_kda_chunk_flops_against_a_hand_count():
    # one chunk of 64 a head: the score matrices (10 sub-block products of
    # 16 x 16 x 128, twice), the solve (2016 multiply-adds a column, 256
    # columns), Kd^T W and Kd^T U, P S, M W, (q e^G - M W) S and M U
    head = 2 * (2 * 10 * 16 * 16 * 128) + 2 * 2016 * 256 + 2 * 2 * 128 * 128 * 64 \
        + 2 * 128 ** 3 + 2 * 64 * 64 * 128 + 2 * 64 * 128 * 128 + 2 * 64 * 64 * 128
    assert drv.kda_chunk_flops(FULL) == 32 * head
    # a prompt of 3 tokens: keys 1, 2 and 3 in MLA, one chunk a KDA layer,
    # logits once
    three = sum(drv.token_flops(FULL, k, False) for k in (1, 2, 3)) \
        + 20 * drv.kda_chunk_flops(FULL) + 2 * 2304 * 163840
    assert drv.prefill_flops(FULL, 3) == pytest.approx(three, rel=1e-12)


def test_seeded_parts_are_the_checkpoint_and_repeat():
    dims = _tiny()
    a = drv.part_weights(dims, SEED, 1, "cpu")
    b = drv.part_weights(dims, SEED, 1, "cpu")
    assert a.keys() == {n for n, _ in ref_kimi.layer_shapes(dims, 1)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    dt = a["model.layers.1.self_attn.dt_bias"].float()
    assert -6.6 < float(dt.min()) and float(dt.max()) < -2.4
    assert 0.4 < float(a["model.layers.1.self_attn.q_conv1d.weight"].float().abs().max()) <= 0.51
    held = [n for n in a if ".mlp.experts." in n]
    assert len(held) == 3 * dims["num_experts"] and "model.layers.1.mlp.experts.7.w" not in a
    assert a["model.layers.1.mlp.gate.weight"].shape[0] == dims["num_router_experts"]


@pytest.mark.parametrize("length", [5, 64, 100, 130])
def test_block_form_equals_the_token_loop(length):
    """The reference's KDA over blocks of 64 (what the check runs) and its
    token-by-token recurrence, from a nonzero state."""
    gen = torch.Generator().manual_seed(length)
    q, k = (ref_kimi.l2_norm(torch.randn(length, 3, 16, generator=gen)) for _ in range(2))
    v = torch.randn(length, 3, 16, generator=gen)
    g = -torch.rand(length, 3, 16, generator=gen) ** 3 * 2
    beta = torch.rand(length, 3, generator=gen)
    s0 = torch.randn(3, 16, 16, generator=gen) * 0.1
    o1, s1 = ref_kimi.recurrence(q, k, v, g, beta, s0)
    o2, s2 = ref_kimi.blocks(q, k, v, g, beta, s0)
    assert float((o1 - o2).abs().max()) <= 1e-5 * float(o1.abs().max())
    assert float((s1 - s2).abs().max()) <= 1e-5 * float(s1.abs().max())


def test_reference_matches_the_port_on_the_cpu():
    """The benchmark's reference (both KDA forms) and the port's prefill,
    then decode through the hybrid cache, in float32 on the same seeded
    weights (the rehearsal's share of 8 of 16 experts), at every decode
    position."""
    from eioku_tpu_torch.models.llm import kimi_linear as kimi

    dims = _tiny()
    parts = {}
    for part in ref_kimi.parts(dims):
        parts.update({k: v.float() for k, v in drv.part_weights(dims, SEED, part, "cpu").items()})
    model = kimi.load_state_dict(kimi.empty_model(kimi.KimiLinearConfig.from_dict(dims),
                                                  torch.float32, "cpu"), parts)
    prompt = [256] + [(i * 37) % 250 for i in range(1, 150)]
    steps = 6
    cache = kimi.make_cache(model, 1, len(prompt) + steps, steps)
    got = [kimi.prefill(model, torch.tensor(prompt), [len(prompt)], cache)]
    fed = [got[0].argmax(-1)]
    pos = torch.tensor([len(prompt)])
    for _ in range(steps):
        got.append(kimi.decode_step(model, fed[-1], pos, cache))
        fed.append(got[-1].argmax(-1))
        pos = pos + 1
    seq = prompt + [int(f[0]) for f in fed[:-1]]
    positions = [list(range(len(prompt) - 1, len(seq)))]
    for form in ("blocks", "tokens"):
        want = ref_kimi.logits(dims, lambda part: parts, [seq], positions,
                               [ref_kimi.KimiLinear(dims, kda=form)], "cpu")[0][0]
        for t in range(steps + 1):
            err = float((got[t][0] - want[t]).abs().max())
            assert err <= 1e-4 * float(want[t].abs().max()), (form, t, err)


def test_rehearsal_from_a_copy_of_the_benchmark(tmp_path):
    """The cell, traced and untraced, from a copy of BENCHMARK.json and
    benchmark/ in another checkout's place."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {**os.environ, "PYTHONPATH": harness.ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for trace, want in (("0", {"audio_s_per_s", "setup_s"}),
                        ("1", {"llm_prefill_ms_per_ktoken", "llm_decode_ms_per_step",
                               "task_self_ms_per_job", "llm_decode_graph_pct"})):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", str(SEED),
             "--seconds", "0", "--trace", trace, "--rehearse"],
            cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["attempted"] == 2
        assert set(result["metrics"]) == want
        assert list(result["checks"]) == ["logit_err", "tok_gap", "route_gap", "unchecked"]


def _faults():
    from eioku_tpu_torch.models.llm import kimi_linear as kimi
    from eioku_tpu_torch.models.llm import model as llm

    gates, project, experts = kimi.kda_gates, llm._project, llm.routed_experts

    def no_decay(layer, cfg, a):
        g, beta = gates(layer, cfg, a)
        return torch.zeros_like(g), beta

    def no_beta(layer, cfg, a):
        g, beta = gates(layer, cfg, a)
        return g, torch.ones_like(beta)

    def rope_in_mla(layer, cfg, x, cos, sin):
        q_nope, q_pe, latent = project(layer, cfg, x, cos, sin)
        r = cfg.qk_rope_head_dim
        inv = 1.0 / (10000 ** (torch.arange(0, r, 2).float() / r))
        emb = torch.outer(torch.arange(x.shape[0]).float(), inv).repeat(1, 2)
        c, s = emb.cos()[:, None], emb.sin()[:, None]
        q_pe = llm._rope(q_pe, c, s)
        k_pe = llm._rope(latent[:, None, cfg.kv_lora_rank:], c, s)[:, 0]
        return q_nope, q_pe, torch.cat([latent[:, :cfg.kv_lora_rank], k_pe], -1)

    def first_expert_dropped(x, gate_up, down, ends):
        y = experts(x, gate_up, down, ends)
        y[:int(ends[0])] = 0
        return y
    return {"no_decay": (kimi, "kda_gates", no_decay), "no_beta": (kimi, "kda_gates", no_beta),
            "rope_in_mla": (llm, "_project", rope_in_mla),
            "held_expert_dropped": (llm, "routed_experts", first_expert_dropped)}


def test_rehearsal_is_correct_unbroken():
    cell = harness.Cell(harness.load_spec(), CELL)
    result, checks = drv.run(cell, SEED, 0.0, trace=False, rehearse=True)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", ["no_decay", "no_beta", "rope_in_mla", "held_expert_dropped"])
def test_fault_is_not_correct(fault, monkeypatch):
    owner, attr, broken = _faults()[fault]
    monkeypatch.setattr(owner, attr, broken)
    cell = harness.Cell(harness.load_spec(), CELL)
    result, checks = drv.run(cell, SEED, 0.0, trace=False, rehearse=True)
    assert not result["correct"], checks


def test_control_is_not_correct(monkeypatch):
    """The reference in float8 in the program's place, on the rehearsal's
    kept jobs, fails one of the cell's limits."""
    seen = {}
    check = drv.check

    def spy(kept, model_cfg, seed, device, control=False):
        seen["r"] = check(kept, model_cfg, seed, device, control=True)
        return seen["r"]
    monkeypatch.setattr(drv, "check", spy)
    cell = harness.Cell(harness.load_spec(), CELL)
    drv.run(cell, SEED, 0.0, trace=False, rehearse=True)
    limits = cell.config["limits"]
    assert seen["r"]["positions"] > 0
    assert any(seen["r"]["control"][k] > limits[k] for k in drv.CHECKED), seen["r"]
    assert math.isfinite(seen["r"]["control"]["logit_err"])
