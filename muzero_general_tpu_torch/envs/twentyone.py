"""Batched simplified Blackjack (port of envs/twentyone.py; reference
games/twentyone.py:228-308).

A card is min(randint(1, 12), 10). The player hits (0) or stands (1); the
episode ends on a stand, a bust or 21, and then, unless the player busted,
the dealer draws to above 16. The reward is +10, 0 or -10 on the ending step
(the reference Game wrapper scales it by 10, twentyone.py:156), 0 otherwise.
Stepping a done state keeps it done with reward 0.

Randomness: the JAX env draws from PRNG keys and its dealer is a
`lax.while_loop`; here every step draws its cards from `generator` as one
[G, 1 + 16] matrix (the hit card, then the dealer's sequence: 16 aces take
the lowest start above 16), or takes that matrix as `cards`. The dealer's
loop is then 16 masked adds, each lane taking cards only while its hand is
<= 16, which is the while loop's result.
"""

from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv

DEALER_DRAWS = 16  # the longest dealer run: 16 aces from a hand of 1


class TwentyOneState(NamedTuple):
    player_hand: torch.Tensor  # [G] int32
    dealer_hand: torch.Tensor  # [G] int32
    done: torch.Tensor  # [G] bool


def draw_cards(shape, generator, device):
    """Cards min(randint(1, 12), 10) as int32 (JAX envs/twentyone.py:17-19)."""
    cards = torch.randint(1, 13, shape, generator=generator, device=device)
    return torch.clamp(cards, max=10).to(torch.int32)


class TwentyOne(TorchEnv):
    observation_shape = (3, 3, 3)
    num_actions = 2  # 0 = Hit, 1 = Stand
    num_players = 1

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None):
        """start: optional [G, 2] int (player card, dealer card); otherwise
        both are drawn."""
        if start is None:
            start = draw_cards((num_games, 2), generator, self.device)
        start = torch.as_tensor(start, dtype=torch.int32, device=self.device)
        if start.shape != (num_games, 2):
            raise ValueError(f"start must be [{num_games}, 2], got {tuple(start.shape)}")
        return TwentyOneState(start[:, 0].clone(), start[:, 1].clone(),
                              torch.zeros((num_games,), dtype=torch.bool, device=self.device))

    def observation(self, state):
        g = state.player_hand.shape[0]
        planes = torch.zeros((g, 3, 3, 3), dtype=torch.float32, device=self.device)
        planes[:, 0] = state.player_hand.to(torch.float32)[:, None, None]
        planes[:, 1] = state.dealer_hand.to(torch.float32)[:, None, None]
        return planes

    def step(self, state, action, generator: Optional[torch.Generator] = None,
             cards: Optional[torch.Tensor] = None):
        """cards: optional [G, 17] int, the hit card then the dealer's 16;
        otherwise drawn from `generator`."""
        g = state.player_hand.shape[0]
        if cards is None:
            cards = draw_cards((g, 1 + DEALER_DRAWS), generator, self.device)
        cards = torch.as_tensor(cards, dtype=torch.int32, device=self.device)
        if cards.shape != (g, 1 + DEALER_DRAWS):
            raise ValueError(f"cards must be [{g}, {1 + DEALER_DRAWS}], got "
                             f"{tuple(cards.shape)}")
        player = torch.where((action == 0) & ~state.done, state.player_hand + cards[:, 0],
                             state.player_hand)
        done_now = (player > 21) | (action == 1) | (player == 21)

        # Dealer draws to > 16 unless the player busted (twentyone.py:295-299)
        dealer_final = state.dealer_hand
        for j in range(1, 1 + DEALER_DRAWS):
            dealer_final = torch.where(dealer_final <= 16, dealer_final + cards[:, j],
                                       dealer_final)
        dealer = torch.where(done_now & (player <= 21), dealer_final, state.dealer_hand)

        # Reward table (twentyone.py:275-285), *10 (Game wrapper :156)
        win = (player <= 21) & ((dealer < player) | (dealer > 21))
        bust = player > 21
        push = (player <= 21) & (dealer == player)
        raw = torch.where(win, 1.0, torch.where(bust, -1.0, torch.where(push, 0.0, -1.0)))
        reward = torch.where(done_now & ~state.done, raw * 10.0, 0.0).to(torch.float32)

        new_state = TwentyOneState(player.to(torch.int32), dealer.to(torch.int32),
                                   state.done | done_now)
        return new_state, reward, new_state.done

    def action_to_string(self, action):
        return f"{action}. {['Hit', 'Stand'][int(action)]}"

    def render(self, state):
        print(f"Dealer hand: {int(state.dealer_hand[0])}")
        print(f"Player hand: {int(state.player_hand[0])}")
