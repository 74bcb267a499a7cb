"""Pong on the engine loop: the minimal fixed-tick workload.

Port of ``demos/pong.py``, which mirrors the reference's scripts/pong.py:
paddle actors as cooperative tasks, a ball integrated per tick, scoring
events. It exercises the task scheduler, the event bus and the tick
cadence without any RTS system (ref: scripts/pong.py:140+), so it has no
engine and no device. Headless: it draws the court to the terminal once
per simulated second.

Run: ``python -m permafrost_engine_tpu_torch.demos.pong [frames]``
"""

from __future__ import annotations

import sys

from permafrost_engine_tpu_torch.core.events import EventBus, EventType
from permafrost_engine_tpu_torch.core.sched import Scheduler, Yield

W, H = 60.0, 20.0
PADDLE_H = 4.0
BALL_SPEED = 0.8
PADDLE_SPEED = 0.6


class Pong:
    def __init__(self):
        self.bus = EventBus()
        self.sched = Scheduler(self.bus)
        self.ball = [W / 2, H / 2]
        self.vel = [BALL_SPEED, BALL_SPEED * 0.37]
        self.paddles = {0: H / 2, 1: H / 2}
        self.score = [0, 0]
        self.sched.create(self.paddle_task, 0, name="paddle_left")
        self.sched.create(self.paddle_task, 1, name="paddle_right")

    def paddle_task(self, task, side):
        """AI paddle: track the ball (a pf.Task-style actor)."""
        while True:
            by = self.ball[1]
            py = self.paddles[side]
            if abs(by - py) > 0.5:
                self.paddles[side] = py + PADDLE_SPEED * (1 if by > py else -1)
            yield Yield()

    def tick(self):
        self.sched.tick()
        b, v = self.ball, self.vel
        b[0] += v[0]
        b[1] += v[1]
        if b[1] <= 0 or b[1] >= H:
            v[1] = -v[1]
        for side, x in ((0, 1.0), (1, W - 1.0)):
            if (side == 0 and b[0] <= x) or (side == 1 and b[0] >= x):
                if abs(b[1] - self.paddles[side]) <= PADDLE_H / 2:
                    v[0] = -v[0]
                    b[0] = x + (1 if side == 0 else -1) * 0.5
                else:
                    self.score[1 - side] += 1
                    self.bus.notify(EventType.SCRIPT_BASE + 1, tuple(self.score))
                    b[:] = [W / 2, H / 2]
        self.bus.service_queue()

    def draw(self):
        rows = [[" "] * int(W) for _ in range(int(H))]
        for side, x in ((0, 1), (1, int(W) - 2)):
            py = int(self.paddles[side])
            for dy in range(-int(PADDLE_H // 2), int(PADDLE_H // 2) + 1):
                if 0 <= py + dy < int(H):
                    rows[py + dy][x] = "#"
        bx, by = int(self.ball[0]), int(self.ball[1])
        if 0 <= by < int(H) and 0 <= bx < int(W):
            rows[by][bx] = "o"
        print("\n".join("".join(r) for r in rows))
        print(f"score: {self.score[0]} - {self.score[1]}")


def main(frames: int = 600, draw: bool = True):
    game = Pong()
    scores = []
    game.bus.subscribe(EventType.SCRIPT_BASE + 1, scores.append)
    for f in range(frames):
        game.tick()
        if draw and f % 60 == 59:
            print(f"--- frame {f + 1} ---")
            game.draw()
    print(f"final score after {frames} frames: {game.score}, "
          f"{len(scores)} score events")
    return game


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 600)
