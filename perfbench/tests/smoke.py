"""A smoke-size cell for the CPU tests: the published mixes on a small ViT
whose 48-px frames pass ``attn_chunk`` (the flash kernel's plain version)
and whose 32-px frames do not."""
import copy

from perfbench import spec

MODEL = dict(img_res=32, patch=8, n_layers=2, d_model=128, n_heads=4,
             d_ff=512, n_classes=1000, distill_token=True, in_channels=3)
# on the peak mix, 96 frames, seeds 0-7: the bf16 program's widest label
# gap 0-0.0118 and labels moved 0-3.1%; the fp8 control's 0.0825-0.271
# and 7.3-30.2% (the trickle's 0.0892-0.263 and 9.4-25.0%)
LIMITS = dict(label_gap=0.04, labels_moved=5.0)


def config() -> dict:
    return dict(name="vit_smoke", model=dict(MODEL), driver="vision_serving",
                dtype="bfloat16",
                attn_impl="pallas", attn_chunk=20, reduced=[])


def limits() -> dict:
    return dict(LIMITS)


def mix(name: str, frames: int = 48) -> dict:
    m = copy.deepcopy(spec.traffic(name))
    m["episode_frames"] = frames
    for c in m["classes"]:
        c["model_res"] = 48 if c["model_res"] > 224 else 32
    return m


def cell(traffic: str) -> dict:
    """The benchmark's DeiT-B cell of the mix, or one like it for a mix that
    no cell runs yet."""
    bench = spec.load_benchmark()
    return next((w for w in bench["workloads"] if w["traffic"] == traffic),
                dict(name=f"deit_b.{traffic}", config="deit_b", traffic=traffic,
                     chips=1))
