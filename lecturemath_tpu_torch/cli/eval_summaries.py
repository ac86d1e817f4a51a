"""Summary evaluation CLI — evaluate generated summaries against GT.

Usage: python -m lecturemath_tpu_torch.cli.eval_summaries <config> [-l lecture]
[-d dataset] [-b baseline_prefix]
(reference equivalent: eval_multiple_summaries.py)
"""

import sys

from ..eval.summary_eval import SummaryEvaluator
from ..pipeline.driver import PipelineDriver, usage_check


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(argv[1], argv[2:], None, None)
    evaluator = SummaryEvaluator()
    baseline_prefix = driver.params.get("b", "")

    for lecture in driver.iter_lectures():
        evaluator.evaluate_lecture(driver.config, driver.database, lecture,
                                   baseline_prefix)

    evaluator.print_totals()
    print("Finished")


if __name__ == "__main__":
    main()
