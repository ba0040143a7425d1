from .align import Aligner
from .pipeline import PreprocessConfig, Preprocessor, slam_frontend_config
from .serving import StreamExecutor, stream_map
from .tracking import Tracker
