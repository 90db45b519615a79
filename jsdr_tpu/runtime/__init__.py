"""Framework services: config, pub/sub, logging with stage timers,
stream-state checkpointing, and the compilation-cache setup."""

from .config import Config  # noqa: F401
from .pubsub import PubSub  # noqa: F401
from .log import Logger, StageTimers  # noqa: F401
from .state import save_state, load_state  # noqa: F401
from .device import init_compile_cache  # noqa: F401
