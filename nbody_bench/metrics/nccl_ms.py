"""nccl_ms: device ms per step of the NCCL kernels on rank 0 (the
replicated schedule's all_gathers and the per-step health reduction)."""


def read(ctx):
    if ctx["world"] < 2 or not ctx["steps"]:
        return None
    us = sum(e["dur"] for e in ctx["events"]
             if e.get("cat") == "kernel" and "nccl" in e["name"].lower())
    return us / ctx["steps"] / 1e3 if us else None
