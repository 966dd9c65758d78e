"""The port's bench brought to tiny shapes for a CPU run: its config loader
(which ``tools/bench_models`` goes through too) adds the tests' tiny
overrides (the flagship's are those of ``graft_entry._flagship(tiny=True)``)
and its batch constants become small.
Imports nothing of jax: the fresh-interpreter import check uses it too."""

from frustum_convnet_tpu_torch import configs

TINY = {None: ["DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"],
        "refine_car": ["DATA.NUM_SAMPLES", "128", "DATA.REFINE_MAX_SPAN", "6.4"],
        "refine_people": ["DATA.NUM_SAMPLES", "128", "DATA.REFINE_MAX_SPAN", "6.4"],
        "det_sample_people": ["DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "4"],
        "det_sample_sunrgbd": ["DATA.NUM_SAMPLES", "256", "DATA.MAX_DEPTH", "4"]}
BATCHES = (2, 4)


def tiny(bench, setattr=setattr) -> None:
    """Patch ``bench`` (the port's module) to tiny shapes and batches;
    ``setattr`` may be pytest's ``monkeypatch.setattr``."""
    load = bench.load_cfg

    def load_tiny(name=None):
        cfg = load(name)
        configs.merge_cfg_from_list(TINY[name], cfg)
        return cfg

    setattr(bench, "load_cfg", load_tiny)
    setattr(bench, "BATCHES", BATCHES)
    setattr(bench, "TRAIN_BATCHES", BATCHES)
    for name in ("SERVING_GROUP", "SERVING_BATCH", "PER_CONFIG_BATCH", "REFINE_TRAIN_BATCH"):
        setattr(bench, name, 2)
    small = {32: BATCHES[0], 128: BATCHES[1]}
    setattr(bench, "SUPPORTED_TRAIN_RECIPES",
            tuple((small[row[0]],) + row[1:] for row in bench.SUPPORTED_TRAIN_RECIPES))
