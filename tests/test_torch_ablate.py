"""The stage-split bench tools and the knockouts they time, on the CPU.

Rows 1 and 8's knockouts (``local_layer.GIN_KNOCKOUTS``, ``csrc/gin_model.cuh``):
the plain versions of the TPU stage stubs (nogather, nobond, noacc, nomlp
and their combination) against the Pallas ``gin_local_model_slots(_ablate=
...)`` in interpret mode at W=128 and W=256, GIN and GIN-VN, D=16, H=32,
L=2, f32 to 1e-5; ``nomessages`` (no JAX stub) against the JAX kernel over
the same layout with every lane empty; row 8's plain version against row
1's on one packing where a knockout keeps the pool independent of the row
order. The ablation library's row-5 form (``ablate_gat_mega``'s ``r5``):
noglue, noscore, noacc and a combination against the Pallas
``gat_local_model_pairs(_ablate=...)`` in interpret mode at the tolerance
of row 5's own test (1e-5 of the output's scale); its ``nogather``, whose
TPU stub has no meaning for a gather by index, against the port's own
definition. The card knockout test's full-depth operands resolve its f32
tolerance. Then each tool's ``main`` with ``--device cpu`` on a small
bucket, one rep: its record has the JAX tool's keys, and ``noonehot`` is
refused."""

import json

import numpy as np
import pytest
import torch

from flowgnn_tpu_torch.bench import (ablate_gat, ablate_gat_mega, ablate_gat_pairs,
                                     ablate_gin_slots, ablate_model, ablate_slots)
from flowgnn_tpu_torch.core import graphs as tg
from flowgnn_tpu_torch.models import base as tb
from flowgnn_tpu_torch.ops import local_layer
from test_torch_cuda import GIN_KNOCKOUT_CASES, GIN_KNOCKOUT_WIDTHS, _gin_model_operands, _port
from test_torch_cuda import _slot_operands as _gin_cluster_operands
from test_torch_gcn_dgn_gat_slots import _slot_operands as _gat_slot_operands
from test_torch_gin_slots import _batches as _gin_batches
from test_torch_gin_slots import _slot_operands as _gin_slot_operands
from test_torch_local_layer import _gat_pairs_operands, _jax_kernel

KO = local_layer.GIN_KNOCKOUTS
# (window, the large graph's nodes): W=128 (a 120-node graph) and W=256.
GIN_CASES = [(128, 120), (256, 250)]
GIN_IDS = [f"W{w}" for w, _ in GIN_CASES]
# The JAX tool's stubs and their combination.
GIN_STUBS = ["nogather", "nobond", "noacc", "nomlp", "nogather,nobond,noacc,nomlp"]


def _bits(stubs: str) -> int:
    return sum(KO[s] for s in stubs.split(","))


@pytest.mark.parametrize("stubs", GIN_STUBS, ids=[s.replace(",", "+") for s in GIN_STUBS])
@pytest.mark.parametrize("name", ["gin", "gin-vn"])
@pytest.mark.parametrize("window,big", GIN_CASES, ids=GIN_IDS)
def test_gin_knockout_plain_versions_match_jax_stubs(stubs, name, window, big, monkeypatch):
    """Row 1's plain version under each knockout against the Pallas kernel
    with the same ``_ablate`` stubs in interpret mode, f32 to 1e-5."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gin_cluster_operands(name == "gin-vn", big, d=16, hid=32)
    assert ops["window"] == window
    expect = _jax_kernel("gin_local_model_slots", dict(ops, _ablate=stubs))
    got = local_layer.gin_local_model_slots(**_port(ops, "cpu"), knockout=_bits(stubs))
    full = local_layer.gin_local_model_slots(**_port(ops, "cpu"))
    assert got.shape == expect.shape and np.abs(expect).max() > 1e-2
    assert not torch.equal(got, full)  # the stub changes the function
    scale = max(1.0, np.abs(expect).max())
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gin", "gin-vn"])
def test_gin_nomessages_plain_version_is_the_empty_layout(name, monkeypatch):
    """``nomessages`` (bit 1, no JAX stub) drops the lane messages and
    keeps the rest (GIN-VN's pooled terms): the JAX kernel over the same
    slot layout with every lane empty computes it."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gin_slot_operands(name, 256, 250)
    empty = ops["slot_meta"].copy()
    empty[:, 0] = 256 - 128  # src − half = W − half: the sentinel
    empty[:, 1:] = -1
    expect = _jax_kernel("gin_local_model_slots", dict(ops, slot_meta=empty))
    got = local_layer.gin_local_model_slots(**_port(ops, "cpu"), knockout=KO["nomessages"])
    scale = max(1.0, np.abs(expect).max())
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knockout", [0, 1, 2, 3, 8, 11], ids=lambda k: f"ko{k}")
@pytest.mark.parametrize("name", ["gin", "gin-vn"])
def test_gin_ell_knockout_plain_version_matches_slots(knockout, name):
    """Row 8's plain version (ELL) against row 1's (slots) on one aligned
    packing of the same graphs, with the model's own operands: a knockout
    that keeps every row's function independent of the row's position
    (nomlp, nomessages, nobond; the slot layout sorts each window's rows by
    degree) leaves the per-window graph pools equal, f32 to 1e-5 of their
    scale."""
    from flowgnn_tpu_torch.core.numerics import FLOAT32
    from flowgnn_tpu_torch.models import gin
    from flowgnn_tpu_torch.params.loaders import params_from_numpy, synthetic_gin_params

    params = params_from_numpy(synthetic_gin_params(3, dim=16, hidden=32, layers=2),
                               FLOAT32, "cpu")
    slot = tb.to_device(_gin_batches(name, 256, 250)["slot"], "cpu")
    ell = _ell_batch_like(name, 256, 250)
    got_slot = local_layer.gin_local_model_slots(**gin.slot_kernel_operands(params, slot),
                                                 knockout=knockout)
    got_ell = local_layer.gin_local_model(**gin.ell_kernel_operands(params, ell),
                                          knockout=knockout)
    scale = max(1.0, got_slot.abs().max().item())
    torch.testing.assert_close(got_ell / scale, got_slot / scale, rtol=1e-5, atol=1e-5)


def _ell_batch_like(name: str, window: int, big: int) -> dict:
    """The k=1 ELL batch of ``test_torch_gin_slots``' graphs, packed as its
    slot batch is (aligned at ``window``)."""
    import test_torch_gin_slots as gs
    from flowgnn_tpu_torch.core import synthetic as ts

    graphs = gs._graphs(ts, name, big)
    packed = tg.pack_graphs_aligned(graphs, window=window, **gs._caps(window))
    batch = tb.as_batch(packed, blocked="local_ell", window=window,
                        block=tb.choose_geometry(name, big)[1])
    assert tb.ell_megakernel(batch, False)
    return tb.to_device(batch, "cpu")


def _noise_shift(kernel: str, vn: bool, big: int, knockouts, std: float) -> float:
    """The largest move, over ``knockouts``, of the card knockout test's
    full-depth prediction (``test_torch_cuda.GIN_KNOCKOUT_WIDTHS``' D=100,
    H=200, L=5 at deviation ``std``), in f64 and in units of its scale, when
    every float operand takes f32-sized relative noise (6e-8, seeded)."""
    ops = _port(_gin_model_operands(kernel, vn, big, d=100, hid=200, layers=5, std=std), "cpu",
                torch.float64)
    ref = getattr(local_layer, f"{kernel}_ref")
    gen = torch.Generator().manual_seed(0)
    noisy = {k: v * (1 + 6e-8 * torch.randn(v.shape, generator=gen, dtype=v.dtype))
             if torch.is_tensor(v) and v.is_floating_point() and k != "vn_col" else v
             for k, v in ops.items()}
    shift = 0.0
    for ko in knockouts:
        want = ref(**ops, knockout=ko)
        scale = max(1.0, want.abs().max().item())
        shift = max(shift, ((ref(**noisy, knockout=ko) - want).abs() / scale).max().item())
    return shift


@pytest.mark.parametrize("kernel", ["gin_local_model_slots", "gin_local_model"],
                         ids=["row1", "row8"])
@pytest.mark.parametrize("big", (120, 250), ids=["W128", "W256"])
def test_gin_knockout_full_depth_operands_resolve_f32(kernel, big):
    """The card test ``test_gin_model_cuda_knockouts_match_plain`` holds the
    kernel to 1e-4 of the scale in f32: on its full-depth GIN-VN operands
    the exact (f64) function moves by under half of that when the operands
    take f32-sized noise, for every knockout it runs, so the check can see
    a fault and not only rounding."""
    assert _noise_shift(kernel, True, big, GIN_KNOCKOUT_CASES, GIN_KNOCKOUT_WIDTHS[1][3]) < 5e-5


def test_gin_knockout_operands_at_02_do_not_resolve_f32():
    """Why the full-depth draw is at 0.05: at the small operands' 0.2, row
    1's nobond on the 250-node GIN-VN graph moves by more than the f32
    tolerance under the same noise."""
    assert _noise_shift("gin_local_model_slots", True, 250, [KO["nobond"]], 0.2) > 1e-4


# The row-5 form's stubs held to the JAX pairs kernel's.
R5_STUBS = ["noglue", "noscore", "noacc", "noscore,noglue"]


@pytest.mark.parametrize("stubs", R5_STUBS, ids=[s.replace(",", "+") for s in R5_STUBS])
@pytest.mark.parametrize("window,big", [(256, 250), (512, 400)], ids=["W256", "W512"])
def test_row5_form_plain_version_matches_jax_pairs_stubs(stubs, window, big, monkeypatch):
    """``gat_mega_ablate_ref("r5", ...)`` against ``gat_local_model_pairs``
    with the same ``_ablate`` stubs in interpret mode, 1e-5 of the output's
    scale (row 5's own tolerance); ``full`` equals row 5's plain version."""
    monkeypatch.setenv("FLOWGNN_PALLAS_INTERPRET", "1")
    ops = _gat_slot_operands("gat", window, big)
    port = _port(ops, "cpu")
    r5 = ablate_gat_mega.row5_operands(port)
    assert torch.equal(ablate_gat_mega.gat_mega_ablate("r5", "full", **r5),
                       local_layer.gat_local_model_slots(**port))
    expect = _jax_kernel("gat_local_model_pairs", dict(_gat_pairs_operands(ops), _ablate=stubs))
    got = ablate_gat_mega.gat_mega_ablate("r5", stubs, **r5)
    scale = np.abs(expect).max()
    assert scale > 1e-2 and got.shape == expect.shape
    np.testing.assert_allclose(got.numpy() / scale, expect / scale, rtol=1e-5, atol=1e-5)


def test_row5_form_nogather_is_the_ports_own_stub():
    """The TPU pairs stub ``nogather`` multiplies the two-hot rows of the
    window's first 8 payload rows (window B's half gathers nothing): no
    meaning for the Hopper kernel, which gathers by index. The port's stub
    is v1's (lane i takes row i mod W, an empty lane stays empty): row 5's
    function over the stack so rewritten."""
    ops = _port(_gat_slot_operands("gat", 256, 250), "cpu")
    r5 = ablate_gat_mega.row5_operands(ops)
    stack = ops["slot_pstack"].reshape(-1, sum(ops["prefix_caps"]))
    lane = torch.arange(stack.shape[1]) % ops["window"]
    moved = torch.where(stack < ops["window"], lane, stack).to(torch.int32).reshape(-1)
    want = local_layer.gat_local_model_slots(**dict(ops, slot_pstack=moved))
    got = ablate_gat_mega.gat_mega_ablate("r5", "nogather", **r5)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no variant"):
        ablate_gat_mega.gat_mega_ablate("r5", "noonehot", **r5)


SMALL = ["--device", "cpu", "--graphs", "6", "--node-cap", "1023", "--reps", "1",
         "--trials", "1", "--dtype", "f32", "--check"]


def _run(tool, argv, capsys) -> tuple[dict, list]:
    rec = tool.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == rec
    return rec, lines


def _variant_keys(rec: dict, variants: list) -> None:
    assert {"metric", "value", "unit", "variants_us"} <= set(rec)
    assert list(rec["variants_us"]) == variants and rec["unit"] == "us/pass"
    assert {f"attrib_{v}_us" for v in variants if v != "full"} <= set(rec)
    assert rec["value"] == rec["variants_us"]["full"] > 0


def test_ablate_gin_slots_main_on_cpu(capsys):
    """The JAX tool's variants and record; the plain versions' launches."""
    rec, lines = _run(ablate_gin_slots, SMALL, capsys)
    assert rec["metric"] == "gin_slots_ablation_us_per_pass"
    _variant_keys(rec, ablate_gin_slots.DEFAULT_VARIANTS.split(","))
    assert rec["production_us"] > 0 and "stage_us" not in rec
    assert sum(ln.startswith("# check ") for ln in lines) == 6
    with pytest.raises(SystemExit, match="no stage stub"):
        ablate_gin_slots.main(SMALL + ["--variants", "full,noonehot"])


def test_ablate_gat_pairs_main_on_cpu(capsys):
    """The JAX tool's variants less ``noonehot``, its record and the
    gather's in-situ factor; ``noonehot`` refused with the reason."""
    rec, _ = _run(ablate_gat_pairs, SMALL + ["--variants", "full,nogather,noacc"], capsys)
    assert rec["metric"] == "gat_pairs_ablation_us_per_pass"
    _variant_keys(rec, ["full", "nogather", "noacc"])
    assert rec["gather_shape"].startswith("gat pairs two-hot") and rec["gather_shape_us"] > 0
    assert np.isfinite(rec["gather_in_situ_factor"])
    jax_default = "full,nogather,noscore,noglue,noacc,noonehot,nogather:noscore:noglue"
    assert ablate_gat_pairs.DEFAULT_VARIANTS.split(",") == [
        v for v in jax_default.split(",") if v != "noonehot"]
    with pytest.raises(SystemExit, match="builds no one-hot"):
        ablate_gat_pairs.main(SMALL + ["--variants", "full,noonehot"])


@pytest.mark.parametrize("model", ["gin", "gin-vn"])
def test_ablate_model_main_on_cpu(model, capsys):
    """The JAX tool's stages, noop the replay of an empty graph."""
    rec, lines = _run(ablate_model, SMALL + ["--model", model], capsys)
    assert list(rec["stages_ms"]) == ["noop", "full", "mega", "embed", "pool"]
    assert rec["metric"] == f"{model.replace('-', '_')}_model_ablation_ms_per_pass"
    assert lines[0].startswith("geometry: window=128 k_blocks=1")
    assert all(v > 0 for v in rec["stages_ms"].values())


@pytest.mark.parametrize("model,stages", [("gat", ["noop", "full", "kernel", "glue", "embed"]),
                                          ("dgn", ["noop", "full", "kernel", "aux", "embed"])])
def test_ablate_slots_main_on_cpu(model, stages, capsys):
    """The JAX tool's stages for GAT and DGN, labelled as it labels them."""
    rec, lines = _run(ablate_slots, SMALL + ["--model", model], capsys)
    assert list(rec["stages_ms"]) == stages and rec["metric"] == f"{model}_slots_ablation_ms_per_pass"
    assert any(ln.startswith(rec["labels"]["kernel"]) and "us/graph" in ln for ln in lines)


def test_ablate_gat_main_on_cpu(capsys):
    """The JAX tool's stages and its skip line where no lane spills."""
    rec, lines = _run(ablate_gat, SMALL, capsys)
    assert list(rec["stages_ms"]) == ["noop", "full", "kernel", "glue", "embed"]
    assert rec["spill_lanes"] == 0
    assert any(ln.startswith("spill tail x5") and "skipped" in ln for ln in lines)


def test_stage_tools_skip_missing_reference_weights(tmp_path, capsys):
    """``--weights reference`` without the reference's files prints a skip
    line and no record."""
    assert ablate_gin_slots.main(SMALL + ["--weights", "reference", "--reference-root",
                                          str(tmp_path)]) is None
    assert "skipped" in capsys.readouterr().out
