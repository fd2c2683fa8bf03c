from guacamole.utils import bases, phred
from guacamole.utils.progress import progress, DelayedMessages
