from repro_torch.learners.replay import DataServer
from repro_torch.learners.samplers import (SAMPLERS, Sampler, SegmentTree,
                                           UniformSampler, PrioritizedSampler,
                                           EpisodeSampler, make_sampler)
from repro_torch.learners.steps import (build_env_train_step, build_mlm_train_step,
                                       build_seq_train_step)
from repro_torch.learners.learner import Learner
