"""The user-facing SVMOGP model.

Counterpart of ``hetmogp_tpu/models/svmogp.py``: a thin stateful wrapper
around a (config, params) pair and the dataset, whose methods call the
port's functions (``models/elbo.py``, ``models/predict.py``, ``train.py``,
``checkpoint.py``).  Where the JAX class takes a ``key`` it takes a numpy
``Generator`` (or a seed) for the initial parameters and a
``torch.Generator`` for draws; ``device=`` places the parameters (the card
unless the caller names another).

    likelihoods = HetLikelihood([HetGaussian(), Bernoulli()])
    cfg = ModelConfig(likelihoods=tuple(likelihoods.likelihoods_list),
                      num_latent=2, num_inducing=20, input_dim=1)
    model = SVMOGP(cfg, X_list, Y_list, Z, seed=0)
    model.fit_svi_on_device(batch_size=512, num_steps=1000,
                            checkpoint_dir="ckpt", resume=True)
    model.save("model.npz")
    m, v = model.predictive_new(Xnew, output_function_ind=0)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.models import predict as predict_mod
from hetmogp_tpu_torch.models.params import (SVMOGPParams, default_lik_theta,
                                             init_params)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class SVMOGP:
    def __init__(self, config: ModelConfig, X: Sequence, Y: Sequence,
                 Z, *, generator: Optional[np.random.Generator] = None,
                 seed: int = 0, params: Optional[SVMOGPParams] = None,
                 W=None, lengthscale=1.0, variance=1.0, device="cuda"):
        self.config = config
        if len(X) != config.num_tasks or len(Y) != config.num_tasks:
            raise ValueError(
                f"got {len(X)} X arrays / {len(Y)} Y arrays for "
                f"{config.num_tasks} likelihoods — one per task required")
        self.Xmulti_all = [np.asarray(x) for x in X]
        self.Ymulti_all = [np.asarray(y) if np.asarray(y).ndim == 2
                           else np.asarray(y)[:, None] for y in Y]
        for t, (x, y, lik) in enumerate(zip(self.Xmulti_all, self.Ymulti_all,
                                            config.likelihoods)):
            if x.ndim != 2 or x.shape[1] != config.input_dim:
                raise ValueError(
                    f"task {t}: X has shape {x.shape}; expected "
                    f"(N_{t}, input_dim={config.input_dim})")
            if y.shape[0] != x.shape[0]:
                raise ValueError(
                    f"task {t}: X has {x.shape[0]} rows but Y has "
                    f"{y.shape[0]}")
            if y.shape[1] != lik.dim_y:
                raise ValueError(
                    f"task {t}: Y has {y.shape[1]} columns but "
                    f"{type(lik).__name__} expects dim_y={lik.dim_y}")
        if params is None:
            rng = (generator if generator is not None
                   else np.random.default_rng(seed))
            params = init_params(rng, config, Z, W=W, lengthscale=lengthscale,
                                 variance=variance, device=device)
        self.params = params
        self.elbo_history = np.zeros((0,))

    @property
    def device(self) -> torch.device:
        return self.params.Z.device

    # ---- whole-model persistence -----------------------------------------
    def save(self, path) -> None:
        """The whole model (params and the serialized ModelConfig) as one
        npz, in the JAX package's layout: ``SVMOGP.load`` of either package
        reads it.  The training data is not stored; pass it to ``load``."""
        from hetmogp_tpu_torch import checkpoint

        checkpoint.save_checkpoint(
            path, self.params,
            extra={"model_config": self.config.to_dict(),
                   "has_lik_theta": self.params.lik_theta is not None})

    @classmethod
    def load(cls, path, X: Sequence, Y: Sequence,
             device="cuda") -> "SVMOGP":
        """Rebuild a model saved with ``save`` (by either package): the
        ModelConfig comes from the checkpoint, the params are checked
        against its shapes, and X/Y re-attach the dataset."""
        from hetmogp_tpu_torch import checkpoint

        meta = checkpoint.peek_meta(path)
        try:
            cfg_dict = meta["extra"]["model_config"]
        except KeyError:
            raise ValueError(
                f"{path!s} is a bare params checkpoint, not a model saved "
                "with SVMOGP.save (no model_config in extra); use "
                "checkpoint.load_checkpoint with your own templates")
        # a malformed config dict raises its own KeyError/TypeError here,
        # deliberately not folded into the bare-checkpoint error above
        cfg = ModelConfig.from_dict(cfg_dict)
        template = init_params(np.random.default_rng(0), cfg,
                               np.zeros((cfg.num_inducing, cfg.input_dim)),
                               with_lik_theta=meta["extra"]["has_lik_theta"],
                               device=device)
        params, _, _, _ = checkpoint.load_checkpoint(path, template)
        return cls(cfg, X, Y, None, params=params)

    # ---- reference-parity accessors -------------------------------------
    @property
    def num_inducing(self) -> int:
        return self.config.num_inducing

    @property
    def num_latent_funcs(self) -> int:
        return self.config.num_latent_eff

    @property
    def num_output_funcs(self) -> int:
        return self.config.num_output_functions

    @property
    def Y_metadata(self) -> dict:
        return self.config.metadata()

    # ---- objective -------------------------------------------------------
    def log_likelihood(self) -> float:
        """The full-data ELBO (``predict.elbo_evaluator``)."""
        from hetmogp_tpu_torch.data import full_batch

        data, scales = full_batch(self.Xmulti_all, self.Ymulti_all,
                                  dtype=self.config.torch_dtype,
                                  device=self.device)
        e, _ = predict_mod.elbo_evaluator(self.config)(
            self.params, data, torch.as_tensor(
                scales, dtype=self.config.torch_dtype, device=self.device))
        return float(e)

    # ---- trainable likelihood parameters --------------------------------
    def _ensure_lik_theta(self, tc: TrainConfig) -> None:
        """Give params.lik_theta its defaults when training is to learn
        likelihood parameters and the likelihoods have any."""
        if (tc.learn_lik_params and self.params.lik_theta is None
                and any(lik.n_theta for lik in self.config.likelihoods)):
            self.params = dataclasses.replace(
                self.params,
                lik_theta=default_lik_theta(self.config, self.device))

    @property
    def pred_config(self) -> ModelConfig:
        """The config for prediction: the likelihoods with any trained
        params.lik_theta absorbed (memoized on theta's values, so equal
        theta gives the same config object)."""
        if self.params.lik_theta is None:
            return self.config
        key = tuple(_numpy(t).tobytes() for t in self.params.lik_theta)
        if getattr(self, "_pred_cfg_key", None) != key:
            self._pred_cfg_key = key
            self._pred_cfg = self.config.with_trained_likelihoods(self.params)
        return self._pred_cfg

    # ---- training --------------------------------------------------------
    def fit_vem(self, train_config: Optional[TrainConfig] = None,
                vem_iters: Optional[int] = None, verbose: bool = False):
        """Batch VEM (``train.vem_algorithm``)."""
        from hetmogp_tpu_torch import train as train_mod

        tc = train_config or TrainConfig()
        if vem_iters is not None:
            tc = dataclasses.replace(tc, vem_iters=vem_iters)
        self._ensure_lik_theta(tc)
        self.params, hist = train_mod.vem_algorithm(
            self.params, self.config, self.Xmulti_all, self.Ymulti_all,
            train_config=tc, verbose=verbose)
        self.elbo_history = np.concatenate([self.elbo_history, hist])
        return self

    def fit_svi(self, batch_size, num_steps: int,
                train_config: Optional[TrainConfig] = None,
                vem: bool = True, callback=None):
        """Stochastic SVI over a host ``MinibatchStream`` (``train.svi_fit``)."""
        from hetmogp_tpu_torch import train as train_mod
        from hetmogp_tpu_torch.data import MinibatchStream

        tc = train_config or TrainConfig()
        self._ensure_lik_theta(tc)
        stream = MinibatchStream(self.Xmulti_all, self.Ymulti_all, batch_size,
                                 shuffle=tc.shuffle, seed=tc.seed,
                                 dtype=self.config.torch_dtype,
                                 device=self.device)
        self.params, hist = train_mod.svi_fit(
            self.params, self.config, tc, stream, num_steps, vem=vem,
            callback=callback)
        self.elbo_history = np.concatenate([self.elbo_history, hist])
        return self

    def fit_svi_on_device(self, batch_size, num_steps: int,
                          train_config: Optional[TrainConfig] = None,
                          vem: bool = True, steps_per_call: int = 100,
                          mesh=None,
                          generator: Optional[torch.Generator] = None,
                          checkpoint_dir=None,
                          checkpoint_every: Optional[int] = None,
                          keep_last: int = 2, resume: bool = False,
                          early_stop_tol: Optional[float] = None,
                          early_stop_patience: int = 3):
        """SVI with the data on the device and the graphed trainer
        (``train.svi_fit_on_device``), with periodic checkpoints and an
        exact resume.  ``mesh``: a ``parallel.sharding`` mesh that every
        rank's model calls with (rows over the data axis, latents over the
        latent axis); the model's params are the full params after it."""
        from hetmogp_tpu_torch import train as train_mod

        tc = train_config or TrainConfig()
        self._ensure_lik_theta(tc)
        self.params, hist = train_mod.svi_fit_on_device(
            self.params, self.config, tc, self.Xmulti_all, self.Ymulti_all,
            batch_size, num_steps, vem=vem, steps_per_call=steps_per_call,
            mesh=mesh, generator=generator, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, keep_last=keep_last,
            resume=resume, early_stop_tol=early_stop_tol,
            early_stop_patience=early_stop_patience)
        self.elbo_history = np.concatenate([self.elbo_history, hist])
        return self

    # ---- prediction ------------------------------------------------------
    def predict_u(self, Xnew, latent_function_ind: Optional[int] = None,
                  full_cov: bool = False):
        return predict_mod.predict_latent_u(self.params, self.config, Xnew,
                                            latent_function_ind,
                                            full_cov=full_cov)

    def predictive_new(self, Xnew, output_function_ind: int = 0,
                       full_cov: bool = False):
        m, v = predict_mod.predict_f(self.params, self.config, Xnew,
                                     output_function_ind, full_cov=full_cov)
        if full_cov:
            return _numpy(m)[:, None], _numpy(v)
        return _numpy(m)[:, None], _numpy(v)[:, None]

    def sample_f(self, Xnew, output_function_ind: int = 0,
                 num_samples: int = 1,
                 generator: Optional[torch.Generator] = None):
        """Correlated posterior samples of f_d at Xnew: (num_samples, N),
        from ``generator`` (a CPU generator seeded 0 when None)."""
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        return _numpy(predict_mod.sample_f(
            self.params, self.config, generator, Xnew, output_function_ind,
            num_samples))

    def predict_f_tasks(self, X_list):
        return predict_mod.predict_f_all(self.params, self.config, X_list)

    def predict_f_projected(self, Xnew, output_function_ind: int = 0):
        """The reference's ``_raw_predict_f``: the posterior at the training
        inputs re-projected through the function-space prior (O(N^3))."""
        m, v = predict_mod.predict_f_projected(
            self.params, self.config, self.Xmulti_all, Xnew,
            output_function_ind)
        return _numpy(m)[:, None], _numpy(v)[:, None]

    def predict_f_stochastic(self, Xnew, output_function_ind: int = 0,
                             Xanchor_list: Optional[Sequence] = None):
        """The reference's ``_raw_predict_stochastic``: the projection from
        ``Xanchor_list`` (the full training inputs by default, a minibatch
        subset to cut the O(N^3) re-projection)."""
        anchors = self.Xmulti_all if Xanchor_list is None else Xanchor_list
        m, v = predict_mod.predict_f_stochastic(
            self.params, self.config, anchors, Xnew, output_function_ind)
        return _numpy(m)[:, None], _numpy(v)[:, None]

    def predictive(self, Xpred: Sequence, projected: bool = False,
                   mesh=None):
        """Observation-space prediction; ``projected=True`` takes the
        reference's training-set re-projection path.  ``mesh`` (every rank
        calling with the same inputs) splits the rows of the direct path
        over the data axis and the latents over the latent axis
        (``predict.predictive_sharded``)."""
        if mesh is not None:
            if projected:
                raise ValueError(
                    "projected=True is the O(N^3) training-set "
                    "re-projection path and is not mesh-sharded; use the "
                    "default direct path with mesh=")
            return predict_mod.predictive_sharded(
                self.params, self.pred_config, Xpred, mesh)
        return predict_mod.predictive(self.params, self.pred_config, Xpred,
                                      Xtrain_list=self.Xmulti_all,
                                      projected=projected)

    def negative_log_predictive(self, Xtest, Ytest, num_samples: int = 1000,
                                generator: Optional[torch.Generator] = None,
                                reference_scaling: bool = True, tasks=None):
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        return float(predict_mod.negative_log_predictive(
            self.params, self.pred_config, generator, Xtest, Ytest,
            num_samples, reference_scaling=reference_scaling, tasks=tasks))

    # ---- plotting (the reference's plot_u, plot_f, plot_pred) ------------
    def plot_u(self, dim: int = 0, num_points: int = 200, ax=None,
               true_U=None, true_UX=None, median: bool = False):
        """Latent-function posterior bands.  median: with several input
        dimensions, fix the others at their training median instead of
        sweeping every dimension together."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 6))
        lo = min(x[:, dim].min() for x in self.Xmulti_all)
        hi = max(x[:, dim].max() for x in self.Xmulti_all)
        Xp = np.linspace(lo, hi, num_points)[:, None]
        if self.config.input_dim > 1:
            if median:
                X_all = np.concatenate(self.Xmulti_all, axis=0)
                Xp = np.tile(np.median(X_all, axis=0)[None, :],
                             (num_points, 1))
                Xp[:, dim] = np.linspace(lo, hi, num_points)
            else:
                Xp = np.tile(Xp, (1, self.config.input_dim))
        mean, var = (_numpy(a) for a in self.predict_u(Xp))
        std = np.sqrt(var)
        for q in range(self.num_latent_funcs):
            ax.plot(Xp[:, dim], mean[:, q], "r-", alpha=0.4)
            ax.fill_between(Xp[:, dim], mean[:, q] - 2 * std[:, q],
                            mean[:, q] + 2 * std[:, q], alpha=0.15)
        if true_U is not None:
            ax.plot(true_UX, true_U, "k+", alpha=0.5)
        return ax

    def plot_f(self, dim: int = 0, num_points: int = 200, ax=None,
               true_F=None, true_FX=None, median: bool = False):
        """Output-function posterior bands; true_F/true_FX overlay per-task
        (N_t, F_t) ground truths and their inputs."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 6))
        f_index = self.config.function_index
        d_index = self.config.d_index
        for d in range(self.num_output_funcs):
            Xt = self.Xmulti_all[f_index[d]]
            line = np.linspace(Xt[:, dim].min(), Xt[:, dim].max(), num_points)
            if self.config.input_dim > 1:
                if median:
                    Xp = np.tile(np.median(Xt, axis=0)[None, :],
                                 (num_points, 1))
                else:
                    Xp = np.tile(line[:, None], (1, self.config.input_dim))
                Xp[:, dim] = line
            else:
                Xp = line[:, None]
            m, v = (_numpy(a) for a in predict_mod.predict_f(
                self.params, self.config, Xp, d))
            s = np.sqrt(v)
            ax.plot(Xp[:, dim], m, "r-", alpha=0.5)
            ax.fill_between(Xp[:, dim], m - 2 * s, m + 2 * s, alpha=0.15)
            if true_F is not None:
                ax.plot(np.asarray(true_FX[f_index[d]])[:, dim],
                        np.asarray(true_F[f_index[d]])[:, d_index[d]],
                        "k-", alpha=0.5)
        return ax

    def plot_pred(self, Xpred, task: int = 0, ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 6))
        m_pred, v_pred = self.predictive(Xpred)
        Xp = np.asarray(Xpred[task])[:, 0]
        m = _numpy(m_pred[task])
        s = np.sqrt(np.maximum(_numpy(v_pred[task]), 0.0))
        ax.plot(self.Xmulti_all[task][:, 0], self.Ymulti_all[task][:, 0],
                "b+", alpha=0.5)
        for j in range(m.shape[1]):
            ax.plot(Xp, m[:, j], "k-")
            ax.plot(Xp, m[:, j] + 2 * s[:, j], "k--", alpha=0.5)
            ax.plot(Xp, m[:, j] - 2 * s[:, j], "k--", alpha=0.5)
        return ax
