"""PyTorch/CUDA port of `reinforcement_learning_in_music_generation_tpu`.

The JAX package beside this one is the reference; this package mirrors its
module names (``config``, ``models.linear_transformer``,
``ops.decode_kernel_v4`` ...) so each counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and keeps its own copies of the
JAX package's host-side modules (config, ``data/``).

Every Pallas kernel on a ported path has a hand-written CUDA counterpart
under ``csrc/``, built at first use (``ops/_build.py``), with a plain
PyTorch version of the same function beside its wrapper.  Wrappers launch
the kernel for CUDA tensors and take the plain version for CPU tensors.

Every command of the JAX package's CLI is ported (``apps/cli.py``): CP song
generation (``generate``, also ``--continuous`` and ``--prompt``) and the
``serve`` daemon, agent pretraining (``pretrain``), the Longformer LM
pretraining (``discrim-pretrain``, ``my-pretrain``), DQN + AIRL and PPO
fine-tuning (``dqn-train``, ``ppo-train``), ``inference``, and the corpus
commands (``prepare-data``, ``preprocess``, ``split-data``, ``data-midi``).
"""

__version__ = "0.1.0"

FIELDS = ("tempo", "chord", "barbeat", "pitch", "duration", "velocity")
"""Per-token compound-word fields, in storage order."""
