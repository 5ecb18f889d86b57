"""Host seconds from the configuration's inputs to the system's finalized
scene on the card (SceneBuilder.finalize: BVH, 4-wide tables, MIP pyramids,
light tables), measured in set-up."""


def read(ctx):
    return ctx.inputs.get("scene_build_s")
