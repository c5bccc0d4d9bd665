"""The `moonlight.chapters` cell on the CPU: its operation and byte counts
against hand counts, the plain reference against the port's CPU path, a
rehearsal from a copy of the benchmark, and the check failing under planted
faults and under the control (the reference in float8 in the program's
place).

    python -m pytest benchmark/tests/test_bench_chapters.py -q
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

from benchmark import harness, roofline, run
from benchmark.drivers import chapters
from benchmark.reference import moonlight as ref_moonlight

SEED = 2_900_000_041
CELL = "moonlight.chapters"
FULL = chapters.dims_of(harness.Cell(harness.load_spec(), CELL).config)


def _tiny() -> dict:
    cell = harness.Cell(harness.load_spec(), CELL)
    model_cfg, _ = chapters.closed_loop.settings(cell, rehearse=True)
    return chapters.dims_of(model_cfg)


def test_the_cell_and_its_driver_are_found_by_name():
    cell = harness.Cell(harness.load_spec(), CELL)
    assert run._driver(cell) is chapters
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "llm_prefill_ms_per_ktoken", "llm_decode_ms_per_step", "moe_roofline",
        "mfu_pct.chapters", "device_idle_pct.chapters", "task_self_ms_per_job",
        "llm_decode_graph_pct"}


def test_the_configuration_holds_every_published_size():
    """The catalog's config.json keys, unchanged: nothing cut."""
    want = {"hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16,
            "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
            "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 11264,
            "moe_intermediate_size": 1408, "n_routed_experts": 64, "num_experts_per_tok": 6,
            "n_shared_experts": 2, "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
            "vocab_size": 163840, "rope_theta": 50000, "rms_norm_eps": 1e-5}
    assert {k: FULL[k] for k in want} == want


def test_token_flops_against_a_hand_count():
    # one decode token at 1,000 keys, logits used
    d, h = 2048, 16
    attn = 2 * d * (h * 192 + 576) + 2 * 512 * h * 256 + 2 * h * 128 * d + 2 * h * 320 * 1000
    dense = 2 * 3 * d * 11264
    sparse = 2 * d * 64 + 2 * 3 * d * 1408 * (6 + 2)
    want = 27 * attn + dense + 26 * sparse + 2 * d * 163840
    assert chapters.token_flops(FULL, 1000, True) == want
    # about 2 x the 2.58 B parameters a token multiplies by: 2.24 B in the
    # layers (3 of 66 experts' in each expert layer) and 0.34 B in lm_head
    assert 5.0e9 < chapters.token_flops(FULL, 0, True) < 5.4e9
    # a prompt of 3 tokens: keys 1, 2 and 3, logits once
    three = sum(chapters.token_flops(FULL, k, False) for k in (1, 2, 3)) + 2 * d * 163840
    assert chapters.prefill_flops(FULL, 3) == pytest.approx(three, rel=1e-12)


def test_expert_bound_against_a_hand_count():
    d, m = 2048, 1408
    # a decode step's layer: 36 pairs over 20 experts: bound by the bytes
    b = (20 * 3 * d * m * 2 + 36 * d * 4) / roofline.PEAK_BYTES_PER_S
    assert chapters.expert_bound_s(FULL, 36, 20) == pytest.approx(b)
    assert b > 2 * 3 * d * m * 36 / roofline.PEAK_FLOPS["bfloat16"]
    # a prefill's layer: 66,000 pairs over all 64 experts: bound by the operations
    f = 2 * 3 * d * m * 66000 / roofline.PEAK_FLOPS["bfloat16"]
    assert chapters.expert_bound_s(FULL, 66000, 64) == pytest.approx(f)


def test_seeded_parts_are_the_checkpoint_and_repeat():
    dims = _tiny()
    a = chapters.part_weights(dims, SEED, 1, "cpu")
    b = chapters.part_weights(dims, SEED, 1, "cpu")
    assert a.keys() == {n for n, _ in ref_moonlight.layer_shapes(dims, 1)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    bias = a["model.layers.1.mlp.gate.e_score_correction_bias"].float()
    assert 0.05 < float(bias.abs().max()) <= 0.101  # +-0.1, rounded to bf16
    assert not torch.equal(chapters.part_weights(dims, SEED + 1, 1, "cpu")[
        "model.layers.1.self_attn.o_proj.weight"], a["model.layers.1.self_attn.o_proj.weight"])


def test_reference_matches_the_port_on_the_cpu():
    """The benchmark's reference and the port's prefill-then-decode, in
    float32 on the same seeded weights, at every decode position."""
    from eioku_tpu_torch.models.llm import model as llm

    dims = {**llm.MODELS["moonlight-16b-a3b"], **_tiny()}
    parts = {}
    for part in ref_moonlight.parts(dims):
        parts.update({k: v.float() for k, v in chapters.part_weights(dims, SEED, part,
                                                                     "cpu").items()})
    model = llm.load_state_dict(
        llm.empty_model(llm.MoonlightConfig.from_dict(dims), torch.float32, "cpu"), parts)
    prompts = [[256, 3, 99, 14, 15, 92, 65], [256, 35, 89, 79]]
    lengths = [len(p) for p in prompts]
    steps = 6
    cache = llm.LatentCache(model.cfg, 2, max(lengths) + steps, steps, torch.float32, "cpu")
    got = [llm.prefill(model, torch.tensor(prompts[0] + prompts[1]), lengths, cache)]
    out = got[0].argmax(-1)
    fed = [out]
    pos = torch.tensor(lengths)
    for _ in range(steps):
        got.append(llm.decode_step(model, fed[-1], pos, cache))
        fed.append(got[-1].argmax(-1))
        pos = pos + 1
    seqs = [p + [int(f[r]) for f in fed[:-1]] for r, p in enumerate(prompts)]
    positions = [list(range(len(p) - 1, len(s))) for p, s in zip(prompts, seqs)]
    want = ref_moonlight.logits(dims, lambda part: parts, seqs, positions,
                                [ref_moonlight.Moonlight(dims)], "cpu")[0]
    for r in range(2):
        for t in range(steps + 1):
            err = float((got[t][r] - want[r][t]).abs().max())
            assert err <= 1e-4 * float(want[r][t].abs().max()), (r, t, err)


def test_rehearsal_from_a_copy_of_the_benchmark(tmp_path):
    """The cell, traced and untraced, from a copy of BENCHMARK.json and
    benchmark/ in another checkout's place."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {**os.environ, "PYTHONPATH": harness.ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    # on the CPU no profiler slice, and no decode graph: 0% of the steps replayed
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
        if trace == "1":
            assert result["metrics"]["llm_decode_graph_pct"]["value"] == 0


def _faults():
    from eioku_tpu_torch.models.llm import model as llm

    route, project, attend = llm.route, llm._project, llm._attend_absorbed

    def no_bias(layer, cfg, x):
        with torch.no_grad():
            saved = layer.router_bias.clone()
            layer.router_bias.zero_()
            try:
                return route(layer, cfg, x)
            finally:
                layer.router_bias.copy_(saved)

    def bias_half(layer, cfg, x):
        with torch.no_grad():
            saved = layer.router_bias.clone()
            layer.router_bias.mul_(0.5)
            try:
                return route(layer, cfg, x)
            finally:
                layer.router_bias.copy_(saved)

    def gate_bf16(layer, cfg, x):
        scores = torch.nn.functional.linear(x.bfloat16(), layer.router.bfloat16()).float()
        experts = torch.topk(scores.sigmoid() + layer.router_bias, cfg.num_experts_per_tok,
                             dim=-1).indices
        w = scores.sigmoid().gather(1, experts)
        return w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor, experts

    def no_renorm(layer, cfg, x):
        _, chosen = route(layer, cfg, x)
        return torch.nn.functional.linear(x.float(), layer.router).sigmoid().gather(1, chosen), \
            chosen

    def k_pe_unrotated(layer, cfg, x, cos, sin):
        q_nope, q_pe, latent = project(layer, cfg, x, cos, sin)
        raw = torch.nn.functional.linear(x, layer.qkv_a)[:, -cfg.qk_rope_head_dim:]
        return q_nope, q_pe, torch.cat([latent[:, :cfg.kv_lora_rank], raw], -1)

    def read_off_by_one(layer, cfg, q_nope, q_pe, kv, valid):
        return attend(layer, cfg, q_nope, q_pe, kv, valid.roll(1, -1))
    return {"no_bias": (llm, "route", no_bias), "no_renorm": (llm, "route", no_renorm),
            "bias_half": (llm, "route", bias_half), "gate_bf16": (llm, "route", gate_bf16),
            "k_pe_unrotated": (llm, "_project", k_pe_unrotated),
            "read_off_by_one": (llm, "_attend_absorbed", read_off_by_one)}


def test_rehearsal_is_correct_unbroken():
    cell = harness.Cell(harness.load_spec(), CELL)
    result, checks = chapters.run(cell, SEED, 0.0, trace=False, rehearse=True)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", ["no_bias", "no_renorm", "k_pe_unrotated", "read_off_by_one",
                                   "bias_half", "gate_bf16"])
def test_fault_is_not_correct(fault, monkeypatch):
    owner, attr, broken = _faults()[fault]
    monkeypatch.setattr(owner, attr, broken)
    cell = harness.Cell(harness.load_spec(), CELL)
    result, checks = chapters.run(cell, SEED, 0.0, trace=False, rehearse=True)
    assert not result["correct"], checks
    if fault in ("bias_half", "gate_bf16"):
        # faults of the router that move choice scores by less than the
        # drift the reference absorbs (AMBIGUITY): routing itself fails
        assert checks["route_gap"][0] > checks["route_gap"][1], checks


def test_control_is_not_correct(monkeypatch):
    """The reference in float8 in the program's place, on the rehearsal's
    kept sections, fails one of the cell's limits."""
    seen = {}
    check = chapters.check

    def spy(kept, model_cfg, seed, device, control=False):
        seen["r"] = check(kept, model_cfg, seed, device, control=True)
        return seen["r"]
    monkeypatch.setattr(chapters, "check", spy)
    cell = harness.Cell(harness.load_spec(), CELL)
    chapters.run(cell, SEED, 0.0, trace=False, rehearse=True)
    limits = cell.config["limits"]
    assert seen["r"]["positions"] > 0
    assert any(seen["r"]["control"][k] > limits[k] for k in chapters.CHECKED), seen["r"]
    assert math.isfinite(seen["r"]["control"]["logit_err"])
