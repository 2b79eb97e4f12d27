"""PyTorch + CUDA port of unav_yolyolva_tpu for NVIDIA Hopper.

The eval (serving) path: `models.build_model(cfg)` and
`eval.make_eval_step(model, cfg)`; the train path: `train.make_optimizer`,
`train.create_train_state` and `train.make_train_step`. It imports neither
JAX nor the JAX package; `utils.convert.params_from_jax` carries JAX
weights across.
"""
