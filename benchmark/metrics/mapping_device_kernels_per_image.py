"""Device activities (kernels, copies, sets) that started inside the mapping
span of the traced pass, per offered image: how many launches the
mapper's host loop makes. None where the trace holds no device activity."""


def read(t):
    if "run_mapping" not in t.stage_windows or not len(t.iv):
        return None
    return t.device_activities_in("run_mapping") / t.images
