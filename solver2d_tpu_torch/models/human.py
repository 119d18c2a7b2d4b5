"""11-bone capsule ragdoll builder (reference: samples/collection/human.cpp:24-348,
human.h:8-42): hip, torso, head(+neck), 2x2 legs (+feet), 2x2 arms; motorized,
limited revolute joints; self-collision filtered by negative group index.
An own copy of the JAX package's `models/human.py`."""

from __future__ import annotations

from ..config import PI, BodyType
from ..world import World

BONES = [
    "hip", "torso", "head",
    "upper_left_leg", "lower_left_leg", "upper_right_leg", "lower_right_leg",
    "upper_left_arm", "lower_left_arm", "upper_right_arm", "lower_right_arm",
]


def spawn_human(w: World, position, scale: float = 1.0, group_index: int = 1) -> dict:
    """Returns {bone_name: body_id, 'joints': [joint ids]}."""
    s = scale
    px, py = position
    max_torque = 0.025 * s
    friction = 0.4
    group = -group_index
    bones: dict = {}
    joints = []

    def body(offset):
        return w.create_body(type=BodyType.DYNAMIC, position=(px + offset[0], py + offset[1]))

    def capsule(b, p1, p2, r, mu=friction):
        w.create_capsule_shape(b, p1, p2, r, friction=mu, filter_group=group)

    def joint(parent, child, pivot_offset, lower, upper, torque):
        pivot = (px + pivot_offset[0], py + pivot_offset[1])
        jid = w.create_revolute_joint(
            parent, child,
            local_anchor_a=w.get_local_point(parent, pivot),
            local_anchor_b=w.get_local_point(child, pivot),
            lower_angle=lower, upper_angle=upper,
            enable_limit=True, enable_motor=True, max_motor_torque=torque,
        )
        joints.append(jid)
        return jid

    # hip (human.cpp:45-55)
    hip = bones["hip"] = body((0.0, 0.95 * s))
    capsule(hip, (0.0, -0.02 * s), (0.0, 0.025 * s), 0.095 * s)

    # torso (human.cpp:57-84)
    torso = bones["torso"] = body((0.0, 1.2 * s))
    capsule(torso, (0.0, -0.135 * s), (0.0, 0.135 * s), 0.09 * s)
    joint(hip, torso, (0.0, 1.025 * s), -0.25 * PI, 0.0, 0.5 * max_torque)

    # head + neck (human.cpp:87-116)
    head = bones["head"] = body((0.0, 1.5 * s))
    capsule(head, (0.0, -0.0325 * s), (0.0, 0.0325 * s), 0.08 * s)
    capsule(head, (0.0, -0.12 * s), (0.0, -0.08 * s), 0.05 * s)
    joint(torso, head, (0.0, 1.4 * s), -0.3 * PI, 0.1 * PI, 0.25 * max_torque)

    # legs (human.cpp:118-236)
    for side in ("left", "right"):
        upper = bones[f"upper_{side}_leg"] = body((0.0, 0.775 * s))
        capsule(upper, (0.0, -0.125 * s), (0.0, 0.125 * s), 0.055 * s)
        joint(hip, upper, (0.0, 0.9 * s), -0.05 * PI, 0.4 * PI, max_torque)

        lower = bones[f"lower_{side}_leg"] = body((0.0, 0.475 * s))
        capsule(lower, (0.0, -0.14 * s), (0.0, 0.125 * s), 0.045 * s)
        # foot, lower friction (human.cpp:36-37,159-160)
        capsule(lower, (-0.02 * s, -0.175 * s), (0.13 * s, -0.175 * s), 0.03 * s, mu=0.1)
        joint(upper, lower, (0.0, 0.625 * s), -0.5 * PI, -0.02 * PI, 0.5 * max_torque)

    # arms (human.cpp:238-344)
    for side in ("left", "right"):
        upper = bones[f"upper_{side}_arm"] = body((0.0, 1.225 * s))
        capsule(upper, (0.0, -0.125 * s), (0.0, 0.125 * s), 0.035 * s)
        joint(torso, upper, (0.0, 1.35 * s), -0.05 * PI, 0.8 * PI, 0.25 * max_torque)

        lower = bones[f"lower_{side}_arm"] = body((0.0, 0.975 * s))
        capsule(lower, (0.0, -0.125 * s), (0.0, 0.125 * s), 0.03 * s)
        joint(upper, lower, (0.0, 1.1 * s), 0.01 * PI, 0.5 * PI, 0.1 * max_torque)

    bones["joints"] = joints
    return bones
