"""DreamerV3: model-based RL on imagined rollouts.

Counterpart: ``ray_tpu/rllib/algorithms/dreamerv3.py`` (ref
``rllib/algorithms/dreamerv3/`` and the DreamerV3 paper's recipe: RSSM
with categorical latents, KL balancing with free bits, symlog predictions,
lambda-return actor-critic on imagination). Discrete actions: reinforce
gradients plus entropy on imagined returns.

Three training pieces, each a function of tensors on
``config.learner_device`` (the card unless the config names the CPU):
world-model learning loops the RSSM over the [B, T] sequences, imagination
loops actor and prior H steps ahead from every posterior state, and the
actor and critic losses backprop through the same loop. Loops over T and H
keep the JAX package's time-first stacking, so every mean reduces the
same elements.

Categorical draws are Gumbel-max: ``jax.random.categorical(key, lg)`` is
``argmax(lg + gumbel)``, so each update takes its Gumbel noise as tensors
(the world model [T, B, groups, classes]; the imagination [H, N, n_act]
for the actor and [H, N, groups, classes] for the prior), drawn from a
``torch.Generator`` on the learner's device with no host read. The
posterior and the prior of one observation step take the same noise, as
they take the same key in the JAX package.

The optimizers are three plain Adams (``optax.adam``: no clipping, a
constant rate, eps 1e-8): the learner's ``make_optimizer`` chain with an
infinite clip. A config with no env (``env=None``, explicit
``observation_dim`` and ``num_actions``) builds the model and its updates
without one; ``train()`` needs an env.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.training import AdamWState
from ray_tpu_torch.models.transformer import _leaves
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.sac import detached
from ray_tpu_torch.rllib.core.learner import (make_optimizer,
                                              params_from_numpy, to_numpy_tree,
                                              to_tensor, trainable)
from ray_tpu_torch.rllib.core.rl_module import params_to


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows by comparison (``F.one_hot`` checks its
    indices on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.batch_size_B: int = 16      # sequences per world-model batch
        self.batch_length_T: int = 16    # timesteps per sequence
        self.horizon_H: int = 15         # imagination depth
        self.gamma: float = 0.997
        self.gae_lambda: float = 0.95
        self.entropy_coeff: float = 3e-3
        self.free_bits: float = 1.0
        self.kl_balance: float = 0.8     # dyn-vs-rep loss split
        self.deter_dim: int = 128
        self.stoch_classes: int = 8      # 8x8 categorical latent
        self.stoch_groups: int = 8
        self.hidden: int = 128
        self.model_lr: float = 1e-3
        self.actor_lr: float = 3e-4
        self.critic_lr: float = 3e-4
        self.updates_per_iteration: int = 8
        self.rollout_fragment_length = 64
        self.replay_capacity_steps: int = 50_000
        self.warmup_steps: int = 500

    def rl_module_spec(self):  # satisfies the base surface; unused here
        return None


def _mlp_init(gen: torch.Generator, sizes):
    params = []
    for i in range(len(sizes) - 1):
        params.append({
            "w": torch.randn((sizes[i], sizes[i + 1]), generator=gen)
            * math.sqrt(2.0 / sizes[i]),
            "b": torch.zeros(sizes[i + 1])})
    return params


def _mlp(params, x, final_act=False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = torch.tanh(x)
    return x


class WorldModel:
    """RSSM + heads. State = (deter h, stoch z); z is groups x classes
    one-hot categoricals with straight-through gradients."""

    def __init__(self, cfg: DreamerV3Config, obs_dim: int, n_act: int):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.n_act = n_act
        self.stoch_dim = cfg.stoch_groups * cfg.stoch_classes
        self.feat_dim = cfg.deter_dim + self.stoch_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        """CPU tensors drawn from ``gen``."""
        cfg = self.cfg
        h, d, s = cfg.hidden, cfg.deter_dim, self.stoch_dim
        return {
            "encoder": _mlp_init(gen, (self.obs_dim, h, h)),
            # GRU: input [stoch + action_onehot], hidden deter
            "gru": _gru_init(gen, s + self.n_act, d),
            "prior": _mlp_init(gen, (d, h, s)),
            "posterior": _mlp_init(gen, (d + h, h, s)),
            "decoder": _mlp_init(gen, (self.feat_dim, h, self.obs_dim)),
            "reward": _mlp_init(gen, (self.feat_dim, h, 1)),
            "cont": _mlp_init(gen, (self.feat_dim, h, 1)),
        }

    # ---- latent machinery

    def _logits_to_stoch(self, logits, noise):
        """One-hot categoricals drawn with Gumbel ``noise`` (shaped
        [..., groups, classes]), straight-through grads."""
        cfg = self.cfg
        lg = logits.reshape(logits.shape[:-1]
                            + (cfg.stoch_groups, cfg.stoch_classes))
        # unimix: 1% uniform keeps every class reachable (paper trick)
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / cfg.stoch_classes
        lg = torch.log(probs)
        idx = torch.argmax(lg + noise, -1)
        st = one_hot(idx, cfg.stoch_classes) + probs - probs.detach()
        return st.reshape(st.shape[:-2] + (self.stoch_dim,)), lg

    def obs_step(self, params, deter, stoch, action_1h, obs, noise):
        """One posterior step: advance deter, infer z from the real obs.
        The posterior and the prior draw with the same noise."""
        deter = _gru(params["gru"], torch.cat([stoch, action_1h], -1), deter)
        prior_logits = _mlp(params["prior"], deter)
        embed = _mlp(params["encoder"], symlog(obs), final_act=True)
        post_in = torch.cat([deter, embed], -1)
        post_logits = _mlp(params["posterior"], post_in)
        stoch, post_lg = self._logits_to_stoch(post_logits, noise)
        _, prior_lg = self._logits_to_stoch(prior_logits, noise)
        return deter, stoch, post_lg, prior_lg

    def img_step(self, params, deter, stoch, action_1h, noise):
        """One prior (imagination) step: no observation."""
        deter = _gru(params["gru"], torch.cat([stoch, action_1h], -1), deter)
        prior_logits = _mlp(params["prior"], deter)
        stoch, _ = self._logits_to_stoch(prior_logits, noise)
        return deter, stoch

    def feat(self, deter, stoch):
        return torch.cat([deter, stoch], -1)


def _gru_init(gen: torch.Generator, in_dim, hid):
    scale = math.sqrt(1.0 / (in_dim + hid))
    return {
        "wi": torch.randn((in_dim, 3 * hid), generator=gen) * scale,
        "wh": torch.randn((hid, 3 * hid), generator=gen) * scale,
        "b": torch.zeros(3 * hid)}


def _gru(p, x, h):
    """The JAX package's GRU, not ``torch.nn.GRUCell``: one fused gate
    product split (r, z, n), candidate ``tanh(r * n)``."""
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    r, z, n = torch.chunk(gates, 3, -1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    n = torch.tanh(r * n)
    return (1 - z) * n + z * h


def _sigmoid_bce(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``, as written there."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


class DreamerV3(Algorithm):
    """Self-contained algorithm (single-process sampling like SAC's local
    path): replay of real sequences -> one world-model update -> one
    imagination actor-critic update per train batch."""

    def __init__(self, config: DreamerV3Config):
        import time as _time

        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        self._start = _time.time()
        # a card learner in a process that sees no card raises here
        self._device = resolve_device(config.learner_device)
        if config.env is None:
            self._env = None
            obs_dim, n_act = config.observation_dim, config.num_actions
        else:
            import gymnasium as gym

            self._env = gym.make(config.env, **config.env_config)
            obs_dim = int(np.prod(self._env.observation_space.shape))
            n_act = int(self._env.action_space.n)
        self.wm = WorldModel(config, obs_dim, n_act)
        gen = torch.Generator().manual_seed(config.seed or 0)
        self.params = trainable(params_to({
            "wm": self.wm.init_params(gen),
            "actor": _mlp_init(gen, (self.wm.feat_dim, config.hidden,
                                     n_act)),
            "critic": _mlp_init(gen, (self.wm.feat_dim, config.hidden, 1)),
        }, self._device))
        # optax.adam: the learner's chain with an infinite clip
        self._opts = {
            "wm": make_optimizer(config.model_lr, math.inf),
            "actor": make_optimizer(config.actor_lr, math.inf),
            "critic": make_optimizer(config.critic_lr, math.inf),
        }
        self._opt_state = {k: self._opts[k].init(self.params[k])
                           for k in self._opts}
        # Gumbel noise of acting and of every update, on the device
        self._gen = torch.Generator(device=self._device).manual_seed(
            config.seed or 0)
        # episode replay: list of dicts of np arrays (obs/action/reward/cont)
        self._episodes = []
        self._replay_steps = 0
        self._rng = np.random.default_rng(config.seed)
        self._act_state = None  # (deter, stoch) carried across env steps
        self._ep_return = 0.0
        self._returns = []
        self._obs = None

    @classmethod
    def get_default_config(cls) -> DreamerV3Config:
        return DreamerV3Config()

    # ------------------------------------------------------------- state

    def get_state(self) -> Dict[str, Any]:
        """Params and the three Adam states as host numpy trees:
        ``{"params", "opt_state": {name: {"count", "mu", "nu"}}}``
        (``_private/convert.py``'s ``dreamer_state_*`` carry JAX's)."""
        return {"params": to_numpy_tree(self.params),
                "opt_state": {k: {"count": int(st.count),
                                  "mu": to_numpy_tree(st.mu),
                                  "nu": to_numpy_tree(st.nu)}
                              for k, st in self._opt_state.items()}}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = params_from_numpy(state["params"], self._device, True)
        self._opt_state = {
            k: AdamWState(count=int(st["count"]),
                          mu=params_from_numpy(st["mu"], self._device),
                          nu=params_from_numpy(st["nu"], self._device))
            for k, st in state["opt_state"].items()}

    # ------------------------------------------------------------ acting

    def _gumbel(self, shape) -> torch.Tensor:
        return gumbel(shape, self._gen, self._device)

    @torch.no_grad()
    def _act_fn(self, params, deter, stoch, prev_action_1h, obs):
        wm, cfg = self.wm, self.config
        deter, stoch, _, _ = wm.obs_step(
            params["wm"], deter, stoch, prev_action_1h, obs,
            self._gumbel((cfg.stoch_groups, cfg.stoch_classes)))
        logits = _mlp(params["actor"], wm.feat(deter, stoch))
        action = torch.argmax(logits + self._gumbel(logits.shape), -1)
        return deter, stoch, action

    def _reset_act_state(self) -> None:
        dev = self._device
        self._act_state = (torch.zeros((self.config.deter_dim,), device=dev),
                           torch.zeros((self.wm.stoch_dim,), device=dev))
        self._prev_a = torch.zeros((self.wm.n_act,), device=dev)

    def _sample_steps(self, n: int) -> None:
        cfg = self.config
        wm = self.wm
        if self._obs is None:
            self._obs, _ = self._env.reset(seed=cfg.seed)
            self._ep = {"obs": [], "action": [], "reward": [], "cont": []}
            self._reset_act_state()
        for _ in range(n):
            obs = to_tensor(np.asarray(self._obs, np.float32), self._device)
            deter, stoch, a_dev = self._act_fn(
                self.params, *self._act_state, self._prev_a, obs)
            if self._total_env_steps < cfg.warmup_steps:
                # the filter state advances during warmup too
                a = int(self._rng.integers(wm.n_act))
            else:
                a = int(a_dev)
            self._act_state = (deter, stoch)
            nxt, r, term, trunc, _ = self._env.step(a)
            self._ep["obs"].append(np.asarray(self._obs, np.float32))
            self._ep["action"].append(a)
            self._ep["reward"].append(float(r))
            self._ep["cont"].append(0.0 if term else 1.0)
            self._prev_a = one_hot(torch.tensor(a, device=self._device),
                                   wm.n_act)
            self._ep_return += float(r)
            self._total_env_steps += 1
            self._obs = nxt
            if term or trunc:
                ep = {k2: np.asarray(v) for k2, v in self._ep.items()}
                self._episodes.append(ep)
                self._replay_steps += len(ep["reward"])
                while self._replay_steps > cfg.replay_capacity_steps \
                        and len(self._episodes) > 1:
                    gone = self._episodes.pop(0)
                    self._replay_steps -= len(gone["reward"])
                self._returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self._env.reset()
                self._ep = {"obs": [], "action": [], "reward": [],
                            "cont": []}
                self._reset_act_state()

    def _sample_batch(self):
        """[B, T] subsequences drawn uniformly over replayed episodes."""
        cfg = self.config
        B, T = cfg.batch_size_B, cfg.batch_length_T
        obs = np.zeros((B, T, self.wm.obs_dim), np.float32)
        act = np.zeros((B, T), np.int32)
        rew = np.zeros((B, T), np.float32)
        cont = np.zeros((B, T), np.float32)
        eligible = [e for e in self._episodes if len(e["reward"]) >= 2]
        for b in range(B):
            ep = eligible[self._rng.integers(len(eligible))]
            L = len(ep["reward"])
            take = min(T, L)
            start = self._rng.integers(0, L - take + 1)
            sl = slice(start, start + take)
            obs[b, :take] = ep["obs"][sl].reshape(take, -1)
            act[b, :take] = ep["action"][sl]
            rew[b, :take] = ep["reward"][sl]
            cont[b, :take] = ep["cont"][sl]
            if take < T:  # pad by repeating the last frame, cont=0
                obs[b, take:] = obs[b, take - 1]
                cont[b, take:] = 0.0
        return {"obs": obs, "action": act, "reward": rew, "cont": cont}

    # ------------------------------------------------- world-model update

    def wm_loss(self, wparams, batch, noise):
        """(loss, aux) of the world model on a [B, T] batch of tensors,
        with Gumbel ``noise`` [T, B, groups, classes]."""
        cfg = self.config
        wm = self.wm
        B, T = batch["action"].shape
        dev = batch["obs"].device
        a1h = one_hot(batch["action"], wm.n_act)
        # previous action feeds each step; step 0 gets zeros
        a_prev = torch.cat([torch.zeros_like(a1h[:, :1]), a1h[:, :-1]], 1)
        deter = torch.zeros((B, cfg.deter_dim), device=dev)
        stoch = torch.zeros((B, wm.stoch_dim), device=dev)
        steps = []
        for t in range(T):
            deter, stoch, post_lg, prior_lg = wm.obs_step(
                wparams, deter, stoch, a_prev[:, t], batch["obs"][:, t],
                noise[t])
            steps.append((deter, stoch, post_lg, prior_lg))
        # stacked time first: [T, B, ...]
        deters, stochs, post_lg, prior_lg = (
            torch.stack(x) for x in zip(*steps))
        feats = wm.feat(deters, stochs)
        recon = _mlp(wparams["decoder"], feats)
        obs_t = torch.swapaxes(batch["obs"], 0, 1)
        recon_loss = torch.mean(torch.sum(
            (recon - symlog(obs_t)) ** 2, -1))
        rew_pred = _mlp(wparams["reward"], feats)[..., 0]
        rew_loss = torch.mean(
            (rew_pred - symlog(torch.swapaxes(batch["reward"], 0, 1)))
            ** 2)
        cont_logit = _mlp(wparams["cont"], feats)[..., 0]
        cont_t = torch.swapaxes(batch["cont"], 0, 1)
        cont_loss = torch.mean(_sigmoid_bce(cont_logit, cont_t))

        # KL balancing with free bits (paper eq. 5)
        def kl(lg_p, lg_q):  # KL(p || q), categorical per group
            p = torch.exp(lg_p)
            return torch.sum(p * (lg_p - lg_q), -1).sum(-1)

        dyn = kl(post_lg.detach(), prior_lg)
        rep = kl(post_lg, prior_lg.detach())
        kl_loss = (cfg.kl_balance * torch.clamp_min(dyn, cfg.free_bits)
                   + (1 - cfg.kl_balance)
                   * torch.clamp_min(rep, cfg.free_bits)).mean()
        loss = recon_loss + rew_loss + cont_loss + kl_loss
        return loss, {"wm_loss": loss, "recon_loss": recon_loss,
                      "kl_loss": kl_loss,
                      "starts": (deters.detach(), stochs.detach())}

    def _wm_update(self, batch, noise) -> Dict[str, Any]:
        """One world-model Adam step in place; returns the aux (metrics as
        0-d tensors and the detached posterior ``starts``)."""
        wparams = self.params["wm"]
        loss, aux = self.wm_loss(wparams, batch, noise)
        grads = torch.autograd.grad(loss, _leaves(wparams))
        self._opts["wm"].update(list(grads), self._opt_state["wm"], wparams)
        return {k: (v if k == "starts" else v.detach())
                for k, v in aux.items()}

    # ------------------------------------------- imagination actor-critic

    def imagine(self, params, starts, actor_noise, prior_noise):
        """H imagined steps from every start state -> (feats, lps, ents,
        deters, stochs, actions), stacked time first [H, N, ...]."""
        cfg = self.config
        wm = self.wm
        deter, stoch = starts
        deter = deter.reshape(-1, cfg.deter_dim)
        stoch = stoch.reshape(-1, wm.stoch_dim)
        steps = []
        for h in range(cfg.horizon_H):
            feat = wm.feat(deter, stoch)
            logits = _mlp(params["actor"], feat)
            a = torch.argmax(logits + actor_noise[h], -1)
            a1h = one_hot(a, wm.n_act)
            logp_all = torch.log_softmax(logits, -1)
            lp = logp_all.gather(1, a[:, None])[:, 0]
            ent = -torch.sum(torch.softmax(logits, -1) * logp_all, -1)
            deter, stoch = wm.img_step(params["wm"], deter, stoch, a1h,
                                       prior_noise[h])
            steps.append((feat, lp, ent, deter, stoch, a))
        return tuple(torch.stack(x) for x in zip(*steps))

    def ac_loss(self, ac_params, wm_params, starts, actor_noise,
                prior_noise):
        """(loss, aux) of the actor and critic on imagination from
        ``starts``; the world model is held fixed."""
        cfg = self.config
        wm = self.wm
        wm_params = detached(wm_params)
        params = {"actor": ac_params["actor"], "wm": wm_params}
        feats, lps, ents, deters, stochs, _ = self.imagine(
            params, starts, actor_noise, prior_noise)
        nxt_feats = wm.feat(deters, stochs)
        rew = symexp(_mlp(wm_params["reward"], nxt_feats)[..., 0])
        cont = torch.sigmoid(_mlp(wm_params["cont"], nxt_feats)[..., 0])
        disc = cfg.gamma * cont
        values = _mlp(ac_params["critic"], feats)[..., 0]
        nxt_values = _mlp(ac_params["critic"], nxt_feats)[..., 0]

        # lambda-returns, computed backwards through the horizon
        rets = [None] * cfg.horizon_H
        nxt_ret = nxt_values[-1]
        for t in range(cfg.horizon_H - 1, -1, -1):
            nxt_ret = (rew[t] + disc[t]
                       * ((1 - cfg.gae_lambda) * nxt_values[t]
                          + cfg.gae_lambda * nxt_ret))
            rets[t] = nxt_ret
        rets = torch.stack(rets)
        adv = (rets - values).detach()
        actor_loss = -(torch.mean(lps * adv)
                       + cfg.entropy_coeff * torch.mean(ents))
        critic_loss = torch.mean((values - rets.detach()) ** 2)
        loss = actor_loss + critic_loss
        return loss, {"actor_loss": actor_loss,
                      "critic_loss": critic_loss,
                      "imagined_return_mean": torch.mean(rets)}

    def _ac_update(self, starts, actor_noise, prior_noise) -> Dict[str, Any]:
        """One Adam step each for the actor and the critic, in place;
        returns the metrics as 0-d tensors."""
        ac = {"actor": self.params["actor"], "critic": self.params["critic"]}
        loss, aux = self.ac_loss(ac, self.params["wm"], starts, actor_noise,
                                 prior_noise)
        grads = torch.autograd.grad(loss, _leaves(ac))
        n = len(_leaves(ac["actor"]))
        for name, g in (("actor", grads[:n]), ("critic", grads[n:])):
            self._opts[name].update(list(g), self._opt_state[name],
                                    self.params[name])
        return {k: v.detach() for k, v in aux.items()}

    def _update_noise(self):
        """One update's Gumbel noise: the world model's, the imagined
        actions' and the imagined prior's."""
        cfg = self.config
        B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H
        G, C = cfg.stoch_groups, cfg.stoch_classes
        return (self._gumbel((T, B, G, C)),
                self._gumbel((H, T * B, self.wm.n_act)),
                self._gumbel((H, T * B, G, C)))

    # ------------------------------------------------------------- train

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self._sample_steps(cfg.rollout_fragment_length)
        # gate on SAMPLABLE steps: only length>=2 episodes can feed
        # _sample_batch, so a replay full of one-step episodes must keep
        # waiting instead of crashing the sampler
        eligible_steps = sum(len(e["reward"]) for e in self._episodes
                             if len(e["reward"]) >= 2)
        if eligible_steps < max(cfg.batch_length_T * 2,
                                cfg.warmup_steps // 4):
            return {"learner": {}, "waiting_for_replay": True}
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(cfg.updates_per_iteration):
            batch = {k: to_tensor(v, self._device)
                     for k, v in self._sample_batch().items()}
            wm_noise, actor_noise, prior_noise = self._update_noise()
            wm_aux = self._wm_update(batch, wm_noise)
            starts = wm_aux.pop("starts")
            ac_aux = self._ac_update(starts, actor_noise, prior_noise)
            metrics = {**wm_aux, **ac_aux}
        # one device-to-host read for the last update's metrics
        names = list(metrics)
        values = torch.stack([metrics[k] for k in names]).tolist()
        return {"learner": {"default_policy": dict(zip(names, values))}}

    def train(self) -> Dict[str, Any]:
        import time as _time

        result = self.training_step()
        self.iteration += 1
        recent = self._returns[-20:]
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "episode_return_mean": (float(np.mean(recent))
                                    if recent else None),
            "time_total_s": _time.time() - self._start,
        })
        return result

    def stop(self) -> None:
        try:
            if self._env is not None:
                self._env.close()
        except Exception:
            pass
