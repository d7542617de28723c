"""Knowledge distillation (reference: contrib/slim/distillation/
distiller.py:25 — the soft-label loss between teacher and student
logits)."""

from __future__ import annotations

from paddle_tpu_torch import layers


def soft_label_distill_loss(student_logits, teacher_logits,
                            temperature: float = 2.0):
    """KL(teacher || student) at temperature T, scaled by T^2 (Hinton's
    correction, so the gradients keep the hard-label scale)."""
    t = float(temperature)
    teacher = layers.softmax(layers.scale(teacher_logits, scale=1.0 / t))
    log_student = layers.log_softmax(
        layers.scale(student_logits, scale=1.0 / t))
    ce = layers.scale(
        layers.reduce_sum(
            layers.elementwise_mul(
                teacher,
                layers.elementwise_sub(
                    layers.log(
                        layers.elementwise_max(
                            teacher,
                            layers.fill_constant_like(teacher, 1e-8))),
                    log_student),
            ),
            dim=-1,
        ),
        scale=t * t,
    )
    return layers.mean(ce)
