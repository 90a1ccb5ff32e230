"""Model diagnosis: virtual-vs-real trajectory comparison, seaborn heatmaps,
graphviz MCTS rendering (port of diagnose.py).

Parity target: reference diagnose_model.py (DiagnoseModel :10-192,
Trajectoryinfo :195-370), as the JAX package has it: the reference's
per-node Python tree is the batched search's SoA Tree (ops/mcts.py), read
at batch index 0.

The searches are the B = 1 staged search with root noise on, its spec from
SearchSpec.from_config(config, batch_size=1, device): at one lane the
kernel gate closes (no lane block fits), so it runs on the plain-op route
on any device, as in JAX. The virtual steps seed their search with
`root_outputs`, the recurrent inference from the previous root's hidden
state. The network is the module itself, in eval mode (the JAX package
passes its variables beside a runner). Searches draw from one
torch.Generator seeded with config.seed; the real trajectory's env draws
from a second one, the same for reset and every step (JAX steps the env
with one key for the whole horizon).

Host envs (gymnasium and the like) are not ported (ROADMAP queue 1 item 8).
"""

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.evaluate import _refuse_host_env
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.support import support_to_scalar


def _root_child_stats(tree, num_simulations):
    """Per-action (prior, policy, value, reward) of the root's children;
    NaN where the action is illegal at the root."""
    prior = tree.children_prior[0, 0].cpu().numpy()  # [A]
    visits = tree.children_visit[0, 0].cpu().numpy()
    vsum = tree.children_vsum[0, 0].cpu().numpy()
    reward = tree.children_reward[0, 0].cpu().numpy()
    value = np.where(visits > 0, vsum / np.maximum(visits, 1), 0.0)
    legal = tree.root_legal[0].cpu().numpy()
    return {
        "prior": np.where(legal, prior, np.nan),
        "policy": np.where(legal, visits / num_simulations, np.nan),
        "value": np.where(legal, value, np.nan),
        "reward": np.where(legal, reward, np.nan),
    }


class Trajectoryinfo:
    """Reference diagnose_model.py:195-370 (same fields and plots)."""

    def __init__(self, title, config):
        self.title = title + ": "
        self.config = config
        self.action_history = []
        self.reward_history = []
        self.prior_policies = []
        self.policies_after_planning = []
        self.values_after_planning = [[np.nan] * len(config.action_space)]
        self.prior_root_value = []
        self.root_value_after_planning = []
        self.prior_rewards = [[np.nan] * len(config.action_space)]
        self.mcts_depth = []

    def store_info(self, out, action, reward, new_prior_root_value=None):
        """Record one search. The network's root value stands in for
        `new_prior_root_value` where that is missing or 0.0, as in JAX."""
        stats = _root_child_stats(out.tree, self.config.num_simulations)
        if action is not None:
            self.action_history.append(int(action))
        if reward is not None:
            self.reward_history.append(float(reward))
        self.prior_policies.append(stats["prior"].tolist())
        self.policies_after_planning.append(stats["policy"].tolist())
        self.values_after_planning.append(stats["value"].tolist())
        self.prior_root_value.append(
            float(out.root_predicted_value[0])
            if not new_prior_root_value
            else float(new_prior_root_value)
        )
        self.root_value_after_planning.append(float(out.root_value[0]))
        self.prior_rewards.append(stats["reward"].tolist())
        self.mcts_depth.append(int(out.max_tree_depth[0]))

    def plot_trajectory(self, save_dir=None, show=True):
        """One seaborn heatmap per field, saved as <title>_<field>.png in
        `save_dir` where given; show=False draws on matplotlib's Agg."""
        import matplotlib

        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn

        def heat(name, data, ticks=True):
            data = np.array(data, dtype=np.float64)
            print(name, data.tolist(), "\n")
            plt.figure(self.title + name)
            ax = seaborn.heatmap(data, mask=np.isnan(data), annot=True, xticklabels=ticks)
            ax.set(xlabel="Action" if data.shape[1] > 1 else None, ylabel="Timestep")
            ax.set_title(name)
            if save_dir is not None:
                plt.savefig(
                    f"{save_dir}/{self.title.strip(': ')}_{name}.png".replace(" ", "_")
                )

        heat("Prior policies", self.prior_policies)
        heat("Policies after planning", self.policies_after_planning)
        if self.action_history:
            heat("Action history", np.transpose([self.action_history]), ticks=False)
        heat("Values after planning", self.values_after_planning)
        heat("Prior root value", np.transpose([self.prior_root_value]), ticks=False)
        heat("Root value after planning", np.transpose([self.root_value_after_planning]),
             ticks=False)
        heat("Prior rewards", self.prior_rewards)
        if self.reward_history:
            heat("Reward history", np.transpose([self.reward_history]), ticks=False)
        heat("MCTS depth", np.transpose([self.mcts_depth]), ticks=False)
        if show:
            plt.show(block=False)


class DiagnoseModel:
    """Reference diagnose_model.py:10-192 on `network` (a MuZero module in
    eval mode) on `device` (None: the card)."""

    def __init__(self, network, config, device=None):
        self.network = network
        self.config = config
        self.device = resolve_device(device)
        self.spec = mcts_ops.SearchSpec.from_config(config, batch_size=1, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)

    @torch.no_grad()
    def _search(self, obs=None, legal=None, to_play=0, root_outputs=None):
        A = len(self.config.action_space)
        if legal is None:
            legal = torch.ones((1, A), dtype=torch.bool, device=self.device)
        return mcts_ops.run_mcts(
            self.network.initial_inference, self.network.recurrent_inference, obs, legal,
            torch.full((1,), to_play, dtype=torch.int32, device=self.device),
            self.generator, self.spec, add_exploration_noise=True,
            root_outputs=root_outputs,
        )

    @torch.no_grad()
    def get_virtual_trajectory_from_obs(self, observation, horizon, plot=True, to_play=0):
        """Unroll the learned model only, with a search at each virtual step
        (reference diagnose_model.py:31-80). observation: [C, H, W]."""
        trajectory_info = Trajectoryinfo("Virtual trajectory", self.config)
        obs = torch.as_tensor(observation, dtype=torch.float32, device=self.device)[None]
        out = self._search(obs, to_play=to_play)
        trajectory_info.store_info(out, None, np.nan)

        virtual_to_play = to_play
        P = len(self.config.players)
        support = self.config.support_size
        for _ in range(horizon):
            action = int(np.argmax(out.root_visit_counts[0].cpu().numpy()))
            virtual_to_play = (virtual_to_play + 1) % P
            root_outputs = self.network.recurrent_inference(
                out.root_hidden, torch.full((1,), action, dtype=torch.long, device=self.device)
            )
            value = float(support_to_scalar(root_outputs[0], support)[0])
            reward = float(support_to_scalar(root_outputs[1], support)[0])
            out = self._search(to_play=virtual_to_play, root_outputs=root_outputs)
            trajectory_info.store_info(out, action, reward, new_prior_root_value=value)

        if plot:
            trajectory_info.plot_trajectory()
        return trajectory_info

    @torch.no_grad()
    def compare_virtual_with_real_trajectories(self, env, horizon, plot=True, start=None):
        """Reference diagnose_model.py:82-140: the virtual trajectory from
        the env's first observation, then the real one along its actions
        until an illegal move, a done or the horizon. `start`: the env's
        start values, as env.reset takes them (default: drawn). Returns
        (virtual, real, divergence_index)."""
        _refuse_host_env(env)
        env_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                                     device=self.device))
        env_generator = torch.Generator(device=self.device).manual_seed(env_seed)
        if start is not None:
            start = torch.as_tensor(start, device=self.device)[None]
        state = env.reset(1, env_generator, start)

        def legal():
            return env.legal_actions_mask(state)

        def to_play():
            return int(env.to_play(state)[0])

        virtual = self.get_virtual_trajectory_from_obs(env.observation(state)[0], horizon,
                                                       False)
        real = Trajectoryinfo("Real trajectory", self.config)
        divergence_index = None
        end_reason = "Reached horizon"

        out = self._search(env.observation(state), legal=legal(), to_play=to_play())
        self.plot_mcts(out.tree, plot)
        real.store_info(out, None, np.nan)
        for i, action in enumerate(virtual.action_history):
            if not bool(legal()[0, action]):
                end_reason = f"Virtual trajectory reached an illegal move at timestep {i}."
                divergence_index = i
                break
            state, reward, done = env.step(
                state, torch.full((1,), action, dtype=torch.long, device=self.device),
                env_generator)
            out = self._search(env.observation(state), legal=legal(), to_play=to_play())
            real.store_info(out, action, float(reward[0]))
            if bool(done[0]):
                end_reason = "Real trajectory reached Done"
                break

        if plot:
            virtual.plot_trajectory()
            real.plot_trajectory()
            print(end_reason)
        return virtual, real, divergence_index

    def close_all(self):
        import matplotlib.pyplot as plt

        plt.close("all")

    def plot_mcts(self, tree, plot=True, filename="mcts"):
        """Graphviz rendering of the search tree (reference
        diagnose_model.py:145-192), walked from the SoA arrays at batch 0.
        Where the `dot` binary fails, the DOT source goes to <filename>.gv.
        Returns the graph (None without the graphviz package)."""
        try:
            from graphviz import Digraph
        except ModuleNotFoundError:
            print("Please install graphviz to get the MCTS plot.")
            return None

        children_index = tree.children_index[0].cpu().numpy()
        children_prior = tree.children_prior[0].cpu().numpy()
        children_visit = tree.children_visit[0].cpu().numpy()
        children_vsum = tree.children_vsum[0].cpu().numpy()
        children_reward = tree.children_reward[0].cpu().numpy()
        root_visit = int(tree.root_visit[0])
        root_vsum = float(tree.root_vsum[0])
        root_reward = float(tree.root_reward[0])

        graph = Digraph(comment="MCTS", engine="neato")
        graph.attr("graph", rankdir="LR", splines="true", overlap="false")
        counter = [0]

        def traverse(node, action, prior, visit, vsum, reward, parent_gid, best):
            # A node's stats are its incoming edge's (edge-array Tree,
            # ops/mcts.py); the root passes its explicit scalars.
            gid = counter[0]
            counter[0] += 1
            value = vsum / visit if visit else 0.0
            graph.node(
                str(gid),
                label=(
                    f"Action: {action}\nValue: {value:.2f}\n"
                    f"Visit count: {visit}\nPrior: {prior:.2f}\n"
                    f"Reward: {reward:.2f}"
                ),
                color="orange" if best else "black",
            )
            if parent_gid is not None:
                graph.edge(str(parent_gid), str(gid), constraint="false")
            kids = children_index[node]
            kid_visits = [children_visit[node][a] for a in range(len(kids)) if kids[a] >= 0]
            best_visits = max(kid_visits) if kid_visits else 0
            for a in range(len(kids)):
                if kids[a] >= 0 and children_visit[node][a] != 0:
                    traverse(
                        kids[a], a, children_prior[node][a],
                        int(children_visit[node][a]),
                        float(children_vsum[node][a]),
                        float(children_reward[node][a]),
                        gid,
                        best_visits and children_visit[node][a] == best_visits,
                    )

        traverse(0, None, 0.0, root_visit, root_vsum, root_reward, None, True)
        graph.node(str(0), color="red")
        try:
            graph.render(filename, view=plot, cleanup=True, format="pdf")
        except Exception as e:  # the dot binary may be missing
            with open(f"{filename}.gv", "w") as f:
                f.write(graph.source)
            print(f"graphviz render failed ({e}); DOT source saved to {filename}.gv")
        return graph
