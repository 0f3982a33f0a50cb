"""The paper's math: BN without moving averages, the hybrid
RMSprop->SGD update, its schedules, and the gradient wire cast."""
