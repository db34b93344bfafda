"""The port's host-only modules are copies it owns. Those that can be are
textual copies of the JAX package's files with only the package name
changed, once the port's tracing (core/profiling.py) is taken out; those
that must differ differ only in the lines listed here."""
import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TEXTUAL = ("data/utils", "data/sentencize", "data/loading", "data/infoseek",
           "train/metrics", "train/data", "train/prefetch", "ops/bm25",
           "ir/metrics", "ir/hp",
           "image/face_box", "image/resize", "interact/system",
           "interact/__init__", "data/evqa", "data/wiki", "data/kilt2vqa",
           "data/labelstudio", "data/mscelebs", "data/wikidump", "data/wit",
           "viz/__init__", "viz/html", "viz/projection", "viz/stats",
           "viz/umap", "viz/wtl_filter")
# module -> the only lines (stripped) that the copy may add or drop
DIFFERS = {
    "ir/fuse": {"import yaml"},
    "core/config": {
        "import yaml",
        "torch/transformers coupling.",
        "transformers coupling. Counterpart of viquae_tpu/core/config.py; "
        "`yaml`",
        "is imported only where a YAML file is read.",
        "config = (yaml.safe_load(text) if path.suffix in "
        "(\".yaml\", \".yml\")",
        "else json.loads(text))",
        "if path.suffix in (\".yaml\", \".yml\"):",
        "config = yaml.safe_load(text)",
        "else:",
        "config = json.loads(text)",
    },
}


def _pair(name):
    ours = (ROOT / "viquae_torch" / f"{name}.py").read_text()
    ref = (ROOT / "viquae_tpu" / f"{name}.py").read_text()
    return ours, ref.replace("viquae_tpu", "viquae_torch")


# ir/server.py after its tracing is taken out, against the reference (the
# module docstring and the transient-error block aside): the ordered
# difference, sign and line. The queue wait of GET /health and the
# request ids; the blank line is the one the profiling import stood on.
SERVER_PORT_DIFF = [
    "+ import itertools",
    "+ ",
    "+         # seconds the dispatched items waited from submit to dispatch",
    "+         self.wait_s = 0.0",
    "+         self._ids = itertools.count()",
    "-         future: Future = Future()",
    "+         future: Future = _Request(next(self._ids))",
    "+ ",
    "+     def mean_wait_ms(self) -> float:",
    '+         """Mean wait of the dispatched items from submit to dispatch."""',
    "+         with self._stats_lock:",
    "+             return 1e3 * self.wait_s / self.n_items if self.n_items "
    "else 0.0",
    "+         started = time.time_ns()",
    "+                 self.wait_s += sum(",
    "+                     started - f.submitted_ns for f in futures) / 1e9",
    '+                         "mean_wait_ms": service.batcher.mean_wait_ms(),',
]
# module -> the lines (stripped, in order) that _without_tracing takes out
TRACING_LINES = {
    "train/data": ["from viquae_torch.core import profiling",
                   'profiling.count_canvas("collate", p.segment_ids)'],
    "ir/server": ["from viquae_torch.core import profiling",
                  'with profiling.span("batcher.dispatch") as dispatch:',
                  "_record_waits(dispatch, futures, started)",
                  'with profiling.span("batcher.collect"):',
                  'with profiling.span("batcher.slot_wait"):'],
}


def _without_tracing(text):
    """The source with its tracing taken out, and the lines taken out
    (stripped): the import of core.profiling, each ``with profiling...:``
    line (its block moves back out by one level), and each statement that
    only records (``profiling.`` or ``_record_waits(`` calls)."""
    out, removed, dedent = [], [], []
    for line in text.splitlines():
        indent = len(line) - len(line.lstrip())
        while dedent and line.strip() and indent <= dedent[-1]:
            dedent.pop()
        stripped = line.strip()
        if stripped.startswith("with profiling.") and stripped.endswith(":"):
            dedent.append(indent)
            removed.append(stripped)
            continue
        if stripped.startswith(("profiling.", "_record_waits(")) \
                or stripped == "from viquae_torch.core import profiling":
            removed.append(stripped)
            continue
        out.append(line[4 * len(dedent):] if line.strip() else line)
    return "\n".join(out) + "\n", removed


@pytest.mark.parametrize("name", TEXTUAL)
def test_copy_equals_reference_but_for_the_package_name(name):
    ours, ref = _pair(name)
    ours, removed = _without_tracing(ours)
    assert removed == TRACING_LINES.get(name, [])
    assert ours == ref


def test_server_equals_reference_but_for_docstring_and_transient_block():
    """ir/server.py: the module docstring is the port's own; the block
    between the shutdown sentinel and DynamicBatcher restates for CUDA
    which device errors are transient, and adds the port's request type
    (its id and arrival time) and the recording of its wait spans. With
    its tracing taken out, every other line is the reference's but the
    queue wait's, SERVER_PORT_DIFF, each in its place."""
    def rest(text):
        body = text[text.index('"""\nfrom __future__'):]
        head, tail = body.split("_SHUTDOWN = object()\n", 1)
        block, tail = tail.split("class DynamicBatcher:", 1)
        return head + tail, block

    ours, ref = _pair("ir/server")
    (ours_rest, ours_block), (ref_rest, ref_block) = rest(ours), rest(ref)
    ours_rest, removed = _without_tracing(ours_rest)
    assert removed == TRACING_LINES["ir/server"]
    changed = [line for line in difflib.ndiff(ref_rest.splitlines(),
                                              ours_rest.splitlines())
               if line[:1] in "+-"]
    assert changed == SERVER_PORT_DIFF
    assert ours_block != ref_block
    assert "def is_transient_device_error(e: BaseException) -> bool:" \
        in ours_block
    assert "STICKY_ERROR_MARKERS" in ours_block
    for tpu_marker in ('"INTERNAL"', '"UNAVAILABLE"', '"ABORTED"',
                       '"RESOURCE_EXHAUSTED"'):
        assert tpu_marker in ref_block and tpu_marker not in ours_block


# train/data.py: the port copies every function and class of the JAX
# module, line for line (the collators and QADataModule with the
# formatting helpers)
DATA_COPIES = ("PreComputedImageFeatures", "ImageFormatter", "tokenize",
               "pack_text_inputs", "mm_visual_mask", "pack_mm_text_inputs",
               "step_indexed_batches", "QADataModule", "stack_microbatches",
               "microbatch_collate", "BiEncoderCollator",
               "JointBiEncoderAndClipCollator", "ReaderCollator", "map_run",
               "CrossModalCollator", "ReRankerCollator", "ICTCollator")


def _top_level_sources(text):
    import ast

    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            start = (node.decorator_list[0].lineno if node.decorator_list
                     else node.lineno)
            out[node.name] = "\n".join(lines[start - 1: node.end_lineno])
    return out


def test_train_data_copies_equal_the_reference_but_for_the_package_name():
    """Line for line, once the port's tracing (the canvas counters of
    ``pack_text_inputs``) is taken out."""
    ours, ref = _pair("train/data")
    ours, removed = _without_tracing(ours)
    assert removed == TRACING_LINES["train/data"]
    ours, ref = _top_level_sources(ours), _top_level_sources(ref)
    assert sorted(ours) == sorted(ref) == sorted(DATA_COPIES)
    for name in DATA_COPIES:
        assert ours[name] == ref[name], name


@pytest.mark.parametrize("name", sorted(DIFFERS))
def test_copy_differs_only_in_the_listed_lines(name):
    ours, ref = _pair(name)
    allowed = DIFFERS[name]
    changed = [
        line[1:].strip() for line in difflib.ndiff(ref.splitlines(),
                                                   ours.splitlines())
        if line[:1] in "+-" and line[1:].strip()]
    assert changed, "the copy is textual: move it to TEXTUAL"
    assert set(changed) <= allowed, sorted(set(changed) - allowed)


# --------------------------------------------------------------------------
# behaviour of the copies that differ, against the JAX package's modules
# --------------------------------------------------------------------------
def test_config_tree_loads_and_instantiates_as_in_jax(tmp_path):
    import json

    import yaml

    from viquae_torch.core import config as tconfig
    from viquae_tpu.core import config as jconfig

    tree = {"_mirror": "a comment", "k": 3,
            "model": {"class_name": "PortTestThing", "width": 4,
                      "_note": "dropped",
                      "inner": [{"class_name": "PortTestThing", "width": 1}]}}
    (tmp_path / "c.json").write_text(json.dumps(tree))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(tree))

    class Thing:
        def __init__(self, width, inner=None):
            self.width, self.inner = width, inner

        @classmethod
        def from_pretrained(cls, path, **kwargs):
            return cls(width=path, **kwargs)

    for module in (tconfig, jconfig):
        module.register("PortTestThing")(Thing)
    for name in ("c.json", "c.yaml"):
        ours = tconfig.load_config(tmp_path / name)
        assert ours == jconfig.load_config(tmp_path / name)
        assert "_mirror" not in ours and "_note" not in ours["model"]
        built = tconfig.load_pretrained_in_config(tmp_path / name)
        assert built["k"] == 3 and built["model"].width == 4
        assert built["model"].inner[0].width == 1
    assert tconfig.get_pretrained("PortTestThing", "a/path").width == "a/path"
    assert tconfig.register(Thing) is Thing   # the bare decorator
    assert tconfig.get_class_from_name("Thing") is Thing
    with pytest.raises(ValueError, match="Unknown class_name"):
        tconfig.get_class_from_name("NoSuchThing")


def test_fusion_fit_and_test_match_jax(tmp_path):
    """ir/fuse.Fusion: fit on dev runs, re-apply the saved parameters to
    test runs, same files and metrics as the JAX package."""
    import json

    import numpy as np

    import viquae_torch.rankeval as trank
    import viquae_tpu.rankeval as jrank
    from viquae_torch.ir.fuse import Fusion as TFusion
    from viquae_tpu.ir.fuse import Fusion as JFusion

    def data(pkg, seed):
        rng = np.random.default_rng(seed)
        qrels = pkg.Qrels({str(q): {str(d): 1 for d in rng.choice(
            30, 2, replace=False)} for q in range(10)})
        runs = [pkg.Run({str(q): {str(d): float(s) for d, s in zip(
            rng.choice(30, 8, replace=False), rng.normal(size=8))}
            for q in range(10)}, name=f"run{r}") for r in range(2)]
        return qrels, runs

    outs = {}
    for label, pkg, cls in (("port", trank, TFusion),
                            ("jax", jrank, JFusion)):
        qrels, runs = data(pkg, 0)
        out = tmp_path / label
        cls(qrels=qrels, runs=runs, output=out, norm="min-max").fit()
        outs[label] = {p.name: json.loads(p.read_text())
                       for p in sorted(out.glob("*.json"))}
    assert outs["port"].keys() == outs["jax"].keys()
    assert "min-max_wsum_best_params.json" in outs["port"]
    assert outs["port"] == outs["jax"]
